"""Worker process of ``tests/test_torch_multihost.py``: one of two processes
of a ``gloo`` group, the port alone (no jax).

Spawned with ``MMRAG_COORDINATOR`` / ``MMRAG_NUM_PROCESSES`` /
``MMRAG_PROCESS_ID`` set, it joins the group through the port's
:func:`mmrag_tpu_torch.parallel.mesh.initialize_multihost` (``device="cpu"``),
then takes one MiniLM MNR step and one CLIP step from the port's seeded
init, each on its own half of the global batch (``tests/tiny_train.py``), as
``tests/dcn_worker.py`` feeds ``make_array_from_process_local_data``. It
writes each step's loss, parameters and all-reduced gradients to the npz
named by its argument and prints ``TORCH_DCN_OK``; any failure exits non-zero.

    python tests/torch_dcn_worker.py OUT.npz
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the tower, its state init and make_*_step, its config in tests/tiny_train.py
TOWERS = (("minilm", "minilm_train_state_init", "make_minilm_train_step", "TRAIN_BERT"),
          ("clip", "train_state_init", "make_train_step", "TRAIN_CLIP"))
BATCH = 8


def run(kind: str, init: str, make: str, cfg: str, rows=slice(None)) -> dict:
    """One step of ``kind`` on ``rows`` of the global batch: its loss,
    parameters and gradients by ``/``-joined path. The port is imported
    here, so the worker's process blocks jax before any of it loads."""

    import tiny_train
    from mmrag_tpu_torch.models.convert import flatten_params
    from mmrag_tpu_torch.parallel import training as ttr

    cfg = getattr(tiny_train, cfg)
    train_batch = tiny_train.train_batch
    params, opt, _ = getattr(ttr, init)(0, None, cfg, device="cpu")
    batch = [a[rows] for a in train_batch(kind, BATCH)]
    params, opt, loss = getattr(ttr, make)(None, cfg)(params, opt, *batch)
    out = {f"{kind}/loss": loss.numpy()}
    grads = {k: t.grad for k, t in _named(params)}
    out.update({f"{kind}/params/{k}": v for k, v in flatten_params(params).items()})
    out.update({f"{kind}/grads/{k}": v for k, v in flatten_params(grads).items()})
    return out


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def main(out_path: str) -> None:
    from mmrag_tpu_torch.parallel.mesh import initialize_multihost

    assert initialize_multihost(device="cpu"), "the coordinator env was not read"
    dist = torch.distributed
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 2 and dist.get_backend() == "gloo", (world, dist.get_backend())
    share = BATCH // world
    results = {}
    for kind, init, make, cfg in TOWERS:
        results.update(run(kind, init, make, cfg, slice(rank * share, (rank + 1) * share)))
    np.savez(out_path, **results)
    dist.destroy_process_group()
    print("TORCH_DCN_OK")


if __name__ == "__main__":
    sys.modules["jax"] = None  # the port runs without jax
    main(sys.argv[1])
