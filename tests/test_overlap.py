"""AIM_TPU_OVERLAP=1 pipelines H2D uploads with kernel execution (no
host blocking between dispatches, 2-wave backpressure) — see
api.align.  Results must be bit-identical
to the sequential path, on multi-wave runs, with and without the
fused-upload transport, and under sharding."""

import numpy as np
import pytest

from aim_tpu import api
from aim_tpu.config import derive_config
from tests.util import pack, random_pairs


def _aligned(cfg, pairs, monkeypatch, overlap, fused=False):
    monkeypatch.setenv("AIM_TPU_OVERLAP", "1" if overlap else "0")
    monkeypatch.setenv("AIM_TPU_FUSED_UPLOAD", "1" if fused else "0")
    pats, txts, pl, tl = pack(pairs, cfg.read_size)
    return api.align(pats, txts, pl, tl, cfg)


@pytest.mark.parametrize("algo", ["nw", "swg", "wfa"])
@pytest.mark.parametrize("fused", [False, True])
def test_overlap_identical(algo, fused, monkeypatch):
    # batch_pairs=8 over 150 pairs => 19 chunks = 3 waves of 8: the
    # overlap loop's backpressure pop and final drain both execute.
    cfg = derive_config(algo, 40, 0.05, backtrace=True,
                        adaptive=(algo == "wfa"), batch_pairs=8)
    pairs = random_pairs(seed=93, n=150, max_len=40)
    base = _aligned(cfg, pairs, monkeypatch, overlap=False)
    ovlp = _aligned(cfg, pairs, monkeypatch, overlap=True, fused=fused)
    np.testing.assert_array_equal(base.scores, ovlp.scores)
    np.testing.assert_array_equal(base.ops, ovlp.ops)
    np.testing.assert_array_equal(base.begin, ovlp.begin)
    np.testing.assert_array_equal(base.end, ovlp.end)
    # phases overlap: the whole pipelined span is booked to t_kernel
    # (api.align attribution contract — energy/device-log consume it)
    assert ovlp.t_kernel > 0
    assert ovlp.t_load == 0 and ovlp.t_retrieve == 0


def test_overlap_under_sharding(monkeypatch):
    jax = pytest.importorskip("jax")
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    devs = np.array(jax.devices()[:8])
    if len(devs) < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = Mesh(devs, ("pairs",))
    sharding = NamedSharding(mesh, P("pairs"))
    monkeypatch.setenv("AIM_TPU_OVERLAP", "1")
    cfg = derive_config("nw", 24, 0.05, backtrace=True, batch_pairs=64)
    pairs = random_pairs(seed=19, n=200, max_len=24)
    pats, txts, pl, tl = pack(pairs, cfg.read_size)
    res = api.align(pats, txts, pl, tl, cfg, device_sharding=sharding)
    from aim_tpu import native
    want, *_ = native.nw_align(pats, txts, pl, tl, mismatch=cfg.mismatch,
                               gap_i=cfg.gap_i, gap_d=cfg.gap_d,
                               backtrace=False)
    np.testing.assert_array_equal(res.scores, want)
