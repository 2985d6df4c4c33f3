"""``ltm_torch.dist.mesh``: the ``mesh_devices`` contract of
``ltm/dist/mesh.py:28-37`` on the CPU and, with ``torch.cuda.device_count``
patched, on one and two cards (one card gives no mesh, as ``ltm`` on one
chip), the padding, the shard layout, and the three collectives on uneven
shards against plain torch ops."""

import pytest
import torch

from ltm_torch.dist import mesh as tm

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [None, 0, 1, -1, 2, 8])
def test_mesh_from_config_cpu(n):
    mesh = tm.mesh_from_config(n, "cpu")
    if n in (None, 0, 1, -1):
        assert mesh is None
    else:
        assert mesh.size == n and mesh.slots == (torch.device("cpu"),) * n
        assert mesh.group is None and mesh.lead == torch.device("cpu")


@pytest.mark.parametrize("cards,n,want", [(1, 8, None), (1, -1, None), (1, 2, None),
                                          (2, 8, 2), (2, -1, 2), (2, 2, 2), (2, 1, None)])
def test_mesh_from_config_cuda(monkeypatch, cards, n, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    mesh = tm.mesh_from_config(n, "cuda")
    if want is None:
        assert mesh is None
    else:
        assert mesh.slots == tuple(torch.device("cuda", i) for i in range(want))


def test_make_mesh_repeats_devices():
    mesh = tm.make_mesh(["cpu", torch.device("cpu"), "cpu"])
    assert mesh.size == 3 and mesh.world == 1 and mesh.rank == 0
    with pytest.raises(ValueError):
        tm.make_mesh([])


def test_pad_to_multiple():
    x = torch.arange(10).reshape(5, 2)
    assert tm.pad_to_multiple(x, 5) is x
    p = tm.pad_to_multiple(x, 4, fill=-1)
    assert p.shape == (8, 2) and torch.equal(p[:5], x) and bool((p[5:] == -1).all())
    m = tm.pad_to_multiple(torch.ones(3, dtype=torch.bool), 8, fill=False)
    assert m.dtype == torch.bool and m.tolist() == [True] * 3 + [False] * 5
    cols = tm.pad_to_multiple(x, 3, axis=1, fill=7)
    assert cols.shape == (5, 3) and bool((cols[:, 2] == 7).all())


def test_local_shards():
    mesh = tm.make_mesh(["cpu"] * 3)
    assert tm.local_shards(mesh, 6) == [(torch.device("cpu"), 0, 2), (torch.device("cpu"), 2, 4),
                                        (torch.device("cpu"), 4, 6)]
    assert [b - a for _, a, b in tm.local_shards(mesh, 0)] == [0, 0, 0]
    with pytest.raises(ValueError):
        tm.local_shards(mesh, 7)


def test_collectives_on_uneven_shards(rng):
    mesh = tm.make_mesh(["cpu"] * 3)
    bools = [torch.from_numpy(rng.uniform(size=50) > 0.8) for _ in range(3)]
    assert torch.equal(tm.reduce_or(mesh, bools), bools[0] | bools[1] | bools[2])
    floats = [torch.from_numpy(rng.normal(size=(4, 7)).astype("float32")) for _ in range(3)]
    want = torch.minimum(torch.minimum(floats[0], floats[1]), floats[2])
    assert torch.equal(tm.reduce_min(mesh, floats), want)
    # shards of 3, 0 and 5 rows, bool and float
    parts = [torch.from_numpy(rng.normal(size=(k, 2)).astype("float32")) for k in (3, 0, 5)]
    assert torch.equal(tm.concat(mesh, parts), torch.cat(parts))
    masks = [torch.ones(2, dtype=torch.bool), torch.zeros(0, dtype=torch.bool),
             torch.zeros(1, dtype=torch.bool)]
    assert tm.concat(mesh, masks).tolist() == [True, True, False]
