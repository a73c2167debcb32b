"""Tests that need an NVIDIA card (marker `gpu`).  Elsewhere they skip;
on a card run them with `python -m pytest tests/ -m gpu`."""

import jax
import numpy as np
import pytest

from aim_tpu.config import derive_config
from tests.test_kernels_xla import assert_matches_oracle

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("algo", ["genasm", "nw", "swg", "wfa"])
def test_device_tier_on_card(gpu_devices, algo):
    """The 100 bp launcher config on the card: exact, nothing on the
    host."""
    from aim_tpu.api import align
    from aim_tpu.datagen import generate_pairs
    cfg = derive_config(algo, 100, 0.01, backtrace=True,
                        adaptive=algo == "wfa")
    pats, txts, pl, tl = generate_pairs(4096, 100, 0.01, cfg.read_size,
                                        seed=5)
    res = align(pats, txts, pl, tl, cfg)
    assert_matches_oracle(res, cfg, pats, txts, pl, tl)


def test_sharded_over_all_cards(gpu_devices):
    from aim_tpu.api import align
    from aim_tpu.datagen import generate_pairs
    from aim_tpu.parallel import make_mesh, pair_sharding
    cfg = derive_config("wfa", 100, 0.01, backtrace=True, adaptive=True)
    pats, txts, pl, tl = generate_pairs(8192, 100, 0.01, cfg.read_size,
                                        seed=7)
    res = align(pats, txts, pl, tl, cfg,
                device_sharding=pair_sharding(make_mesh()))
    assert_matches_oracle(res, cfg, pats, txts, pl, tl)


@pytest.mark.parametrize("algo,length", [("wfa", 10_000), ("nw", 1000),
                                         ("swg", 1000)])
def test_long_read_step_fits_its_memory_figure(gpu_devices, algo, length):
    """The long-read steps as compiled for the card: per pair they take
    no more than api.per_pair_bytes says, so the batch the cap plans
    fits the card."""
    from aim_tpu import api
    cfg = derive_config(algo, length, 0.01, backtrace=True, variant="hbm",
                        adaptive=algo == "wfa")
    bs, _ = api._plan_bs(cfg, 1 << 20, 1)
    R = cfg.read_size
    args = (jax.ShapeDtypeStruct((bs, R), np.uint8),
            jax.ShapeDtypeStruct((bs, R), np.uint8),
            jax.ShapeDtypeStruct((bs,), np.int32),
            jax.ShapeDtypeStruct((bs,), np.int32))
    ma = api._forward_fn(cfg).lower(*args, cfg=cfg).compile() \
        .memory_analysis()
    total = (ma.temp_size_in_bytes + ma.argument_size_in_bytes
             + ma.output_size_in_bytes)
    print(f"{algo} l={length} batch={bs}: temp={ma.temp_size_in_bytes} "
          f"args={ma.argument_size_in_bytes} out={ma.output_size_in_bytes} "
          f"per_pair={total / bs:.0f} figure={api.per_pair_bytes(cfg)}")
    assert total / bs <= api.per_pair_bytes(cfg)
    limit = gpu_devices[0].memory_stats()["bytes_limit"]
    assert total <= limit
