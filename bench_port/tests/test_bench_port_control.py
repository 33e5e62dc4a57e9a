"""The lower-precision controls come out not correct, at test size on the
CPU: the bf16 configuration's controls are the system's own W8A8 path and
the reference at fp8 in the system's place; the W8A8 configuration's is
the reference at int4, its CLIP text tower (bf16 in the system) at fp8."""

import json

import pytest

from bench_port import control, run
from bench_port.harness.manifest import Manifest

from .test_bench_port_cpu_run import root  # noqa: F401  (the tiny copy)


def test_program_control_fails(root, capsys):  # noqa: F811
    rc = run.main(["--workload", "tiny-chat", "--seed", "3000000011", "--seconds", "2",
                   "--trace", "0"], root=root, device="cpu", config="tiny-w8a8")
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and res["correct"] is False, res["checks"]


@pytest.mark.parametrize("config", ["tiny", "tiny-w8a8"])
def test_reference_control_fails(root, config):  # noqa: F811
    """The reference at fp8 (bf16's control) and at int4 with CLIP's text
    tower at fp8 (W8A8's) in the system's place."""

    spec = Manifest(root).cell("tiny-chat", config)
    seed = 3000000013
    out = control.reference_control(spec, seed, 2.0, "cpu")
    assert out["correct"] is False, out["checks"]
    assert out["checks"]["rerank_err"]["value"] > out["checks"]["rerank_err"]["limit"]
