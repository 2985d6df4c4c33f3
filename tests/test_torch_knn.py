"""The port's 2-NN (plain version of the CUDA kernel, the path CPU tensors
take) vs ``ltm``'s Pallas kernel in interpret mode and its XLA scan, plus
the port's general-k ``knn_sqdists`` vs ``ltm``'s.

The CUDA kernel itself needs the card: ``chip_smoke.py`` holds it against
``knn2_sqdists_plain`` there, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ltm.kernels import knn as jknn
from ltm.kernels.pallas_knn import knn2_sqdists_pallas
from ltm_torch.kernels import knn as tknn
from ltm_torch.kernels.knn2 import knn2_sqdists, knn2_sqdists_plain

torch.set_num_threads(1)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _masked_case(rng):
    q = rng.normal(size=(700, 3)).astype(np.float32) * 5
    t = rng.normal(size=(1500, 3)).astype(np.float32) * 5
    qm = np.ones(700, bool)
    qm[13] = False
    tm = rng.uniform(size=1500) > 0.2
    return q, qm, t, tm


def _duplicate_case():
    t = np.array([[1.0, 0, 0], [1.0, 0, 0], [5.0, 0, 0]], np.float32)
    t = np.tile(t, (200, 1))[:512]
    return np.zeros((8, 3), np.float32), np.ones(8, bool), t, np.ones(len(t), bool)


def _one_ulp(a, b):
    return np.all(np.abs(a - b) <= np.spacing(np.maximum(np.abs(a), np.abs(b))))


def test_plain_matches_pallas_masked(rng):
    q, qm, t, tm = _masked_case(rng)
    ref = np.asarray(knn2_sqdists_pallas(*_j(q, qm, t, tm), bq=256, bt=512, interpret=True))
    got = knn2_sqdists(*_t(q, qm, t, tm)).numpy()
    np.testing.assert_allclose(got[qm], ref[qm], rtol=1e-4, atol=1e-5)
    assert np.all(got[~qm] == 1e30)


def test_plain_matches_pallas_duplicates():
    q, qm, t, tm = _duplicate_case()
    ref = np.asarray(knn2_sqdists_pallas(*_j(q, qm, t, tm), bq=8, bt=512, interpret=True))
    got = knn2_sqdists(*_t(q, qm, t, tm)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got, np.full((8, 2), 1.0), atol=1e-6)


@pytest.mark.parametrize("case", ["masked", "duplicates"])
def test_plain_matches_xla_knn_sqdists(rng, case):
    q, qm, t, tm = _masked_case(rng) if case == "masked" else _duplicate_case()
    ref = np.asarray(jknn.knn_sqdists(*_j(q, qm, t, tm), k=2, tile=256))
    got = knn2_sqdists_plain(*_t(q, qm, t, tm)).numpy()
    assert _one_ulp(got[qm], ref[qm])
    np.testing.assert_array_equal(got[~qm], ref[~qm])


def test_plain_km_scale_decisions_match_xla(rng):
    # survey coordinates ~1e3 m from the origin at 0.05 m spacing: the
    # pipeline's operating point; its decisions are the mean < 0.04 / < 1.0
    grid = np.stack(np.meshgrid(np.arange(40), np.arange(40), np.arange(3)), -1).reshape(-1, 3)
    t = (grid * 0.05 + [1000.0, -700.0, 3.0]).astype(np.float32)
    t = t + rng.normal(0, 0.01, t.shape).astype(np.float32)
    q = t[rng.choice(len(t), 1500)] + rng.normal(0, 0.2, (1500, 3)).astype(np.float32)
    qm = rng.uniform(size=len(q)) > 0.2
    tm = rng.uniform(size=len(t)) > 0.2
    ref = np.asarray(jknn.knn_sqdists(*_j(q, qm, t, tm), k=2)).mean(-1)
    got = tknn.knn_avg_sqdist(*_t(q, qm, t, tm)).numpy()
    assert _one_ulp(got[qm], ref[qm])
    for thr in (0.04, 1.0):
        np.testing.assert_array_equal(got < thr, ref < thr)
        assert 0 < (got[qm] < thr).sum() < qm.sum() or thr == 1.0


def test_knn_sqdists_k3_matches_xla(rng):
    q, qm, t, tm = _masked_case(rng)
    ref = np.asarray(jknn.knn_sqdists(*_j(q, qm, t, tm), k=3, tile=256))
    got = tknn.knn_sqdists(*_t(q, qm, t, tm), k=3, tile=256).numpy()
    assert _one_ulp(got[qm], ref[qm])
    np.testing.assert_array_equal(got[~qm], ref[~qm])
    # and the chunked statistic streams queries without changing values
    avg = tknn.chunked_knn_avg_sqdist(*_t(q, qm, t, tm), k=3, tile=256, query_chunk=128).numpy()
    np.testing.assert_array_equal(avg, got.mean(-1))


def test_wrapper_rejects_bad_inputs():
    q, qm, t, tm = _t(*_duplicate_case())
    with pytest.raises(ValueError):
        knn2_sqdists(q.double(), qm, t, tm)
    with pytest.raises(ValueError):
        knn2_sqdists(q, qm[:4], t, tm)
