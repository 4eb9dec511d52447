"""The port's max-mip pyramid against the reference's.

A max is exact, so levels must be bit-equal; ``pyramid_from_jax`` must lay
the reference's padded levels out exactly as the port's ``padded_levels``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from horayzon_tpu.ops import mip as mip_ref
from horayzon_tpu.ops import pallas_sweep
from horayzon_tpu_torch.ops import mip

from reference_impl import gaussian_bumps_terrain


@pytest.mark.parametrize("shape", [(37, 53), (64, 65), (5, 2), (1, 9)])
def test_build_pyramid_bit_equal(shape):
    z = np.random.default_rng(7).uniform(-50, 900, shape).astype(np.float32)
    n_levels = 5
    got = mip.build_pyramid(torch.from_numpy(z), n_levels)
    ref = mip_ref.build_pyramid(jnp.asarray(z), n_levels)
    assert len(got) == len(ref) == n_levels
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert [tuple(g.shape) for g in got] == \
        mip.level_shapes(shape, n_levels)


def test_pyramid_from_jax_reproduces_padded_levels():
    z = gaussian_bumps_terrain(70, 83, seed=2, amp=300.0)
    plan = pallas_sweep.plan_sweep(
        z.shape, inner_shape=(16, 32), offset=(20, 24), tile=(16, 32),
        azim_num=4, dist_search=14000.0, dx=25.0, dy=-25.0)
    padded, _ = pallas_sweep.build_padded_pyramid(
        jnp.asarray(z), plan["pads"], plan["levels_meta"])
    got = mip.pyramid_from_jax([np.asarray(p) for p in padded],
                               plan["pads"], "cpu")
    own = mip.padded_levels(torch.from_numpy(z), plan["pads"])
    assert len(got) == len(own) == len(plan["pads"]) == 3
    for g, o in zip(got, own):
        assert g.dtype == torch.float32 and g.is_contiguous()
        assert torch.equal(g, o)
    assert own[0][0, 0].item() == mip.PAD_VALUE == mip_ref.PAD_VALUE
    with pytest.raises(ValueError, match="levels for"):
        mip.pyramid_from_jax([np.asarray(p) for p in padded[:2]],
                             plan["pads"], "cpu")
