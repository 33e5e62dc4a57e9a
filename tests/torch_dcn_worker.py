"""Worker process of ``tests/test_torch_multihost.py``: one of two processes
of a ``gloo`` group, the port alone (no jax).

Spawned with ``MMRAG_COORDINATOR`` / ``MMRAG_NUM_PROCESSES`` /
``MMRAG_PROCESS_ID`` set, it joins the group through the port's
:func:`mmrag_tpu_torch.parallel.mesh.initialize_multihost` (``device="cpu"``),
then either

* (``train``, the default) takes one MiniLM MNR step and one CLIP step from
  the port's seeded init, each on its own half of the global batch
  (``tests/tiny_train.py``), as ``tests/dcn_worker.py`` feeds
  ``make_array_from_process_local_data``, and writes each step's loss,
  parameters and all-reduced gradients; or
* (``search``) runs ``tests/dcn_worker.py``'s part 1: a corpus-sharded
  top-k through :func:`~mmrag_tpu_torch.parallel.sharded_index.sharded_topk_fn`
  where the process holds only its own half of the rows, on a 2-shard mesh
  of its own, and the merge crosses the process boundary; it writes the
  scores and global ids, and those of the same search without the group
  (this process's rows alone).

It writes the npz named by its argument and prints ``TORCH_DCN_OK``; any
failure exits non-zero.

    python tests/torch_dcn_worker.py OUT.npz [train|search]
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


SEARCH_K = 10
SEARCH_SHARDS = 2  # each process's own mesh (JAX's worker: 2 local devices)


def search_inputs():
    """The global corpus every process can build (``tests/dcn_worker.py``'s
    recipe, 64 x 16 unit rows), with row 40 (process 1's) a copy of row 3
    (process 0's), so an exact tie crosses the process boundary; 4 queries
    near rows 3, 5, 6 and 50; the ``(n,)`` mask (row 9 dead)."""

    n, d = 64, 16
    rng = np.random.default_rng(0)
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=1, keepdims=True)
    corpus[40] = corpus[3]
    queries = corpus[[3, 5, 6, 50]] + 0.01 * rng.standard_normal((4, d)).astype(np.float32)
    mask = np.ones((n,), bool)
    mask[9] = False
    return corpus, queries, mask


def search(rank: int, world: int) -> dict:
    """This process's rows of :func:`search_inputs` on its own mesh, merged
    across the group."""

    from mmrag_tpu_torch.parallel.mesh import build_mesh, row_sharded
    from mmrag_tpu_torch.parallel.sharded_index import sharded_topk_fn

    corpus, queries, mask = search_inputs()
    rows = corpus.shape[0] // world
    mine = slice(rank * rows, (rank + 1) * rows)
    mesh = build_mesh(devices=["cpu"] * SEARCH_SHARDS)
    args = (torch.from_numpy(queries), row_sharded(mesh, corpus[mine]),
            row_sharded(mesh, mask[mine]))
    scores, ids = sharded_topk_fn(mesh, SEARCH_K, group=torch.distributed.group.WORLD)(*args)
    # without a group the search stays this process's, inside the group too
    local_s, local_i = sharded_topk_fn(mesh, SEARCH_K)(*args)
    return {"search/scores": scores.numpy(), "search/ids": ids.numpy(),
            "search/local_scores": local_s.numpy(), "search/local_ids": local_i.numpy()}


def _named(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def main(out_path: str, mode: str = "train") -> None:
    from mmrag_tpu_torch.parallel.mesh import initialize_multihost

    assert initialize_multihost(device="cpu"), "the coordinator env was not read"
    dist = torch.distributed
    rank, world = dist.get_rank(), dist.get_world_size()
    assert world == 2 and dist.get_backend() == "gloo", (world, dist.get_backend())
    if mode == "search":
        results = search(rank, world)
    else:
        share = BATCH // world
        results = {}
        for kind, init, make, cfg in TOWERS:
            results.update(run(kind, init, make, cfg, slice(rank * share, (rank + 1) * share)))
    np.savez(out_path, **results)
    dist.destroy_process_group()
    print("TORCH_DCN_OK")


if __name__ == "__main__":
    sys.modules["jax"] = None  # the port runs without jax
    main(*sys.argv[1:3])
