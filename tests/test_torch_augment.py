"""The port's SpecAugment against ``ss_asr_tpu.ops.augment`` on the CPU.

The JAX function draws its four uniforms inside from a key; the port takes
them as inputs.  Here the port is fed the uniforms that JAX's own key
splits produce (``split(key) -> (freq, time)``, each split into (widths,
starts)), so the two must agree: the masks exactly, the values (each
utterance's mean over its valid frames where masked) within 1e-6, the
padding frames unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ss_asr_tpu.ops import augment as jaug
from ss_asr_tpu_torch.ops import augment

CONFIGS = {
    "default": {},
    "wide": {"n_freq_masks": 3, "freq_mask_width": 12, "n_time_masks": 4, "time_mask_width": 30},
    "adaptive_size": {"adaptive_size_ratio": 0.2},
    "adaptive_both": {"n_time_masks": 3, "adaptive_size_ratio": 0.13,
                      "adaptive_number_ratio": 0.05},
}


def jax_draws(key, B, cfg):
    """The uniforms ``ss_asr_tpu.ops.augment.spec_augment(key, ...)`` draws."""
    kf, kt = jax.random.split(key)
    out = []
    for k, n in ((kf, cfg.n_freq_masks), (kt, cfg.n_time_masks)):
        out += [np.array(jax.random.uniform(s, (B, n))) for s in jax.random.split(k)]
    return out


def batch(rng, B=6, T=120, F=40):
    lens = rng.integers(1, T + 1, size=B)
    lens[0], lens[1] = T, 7
    x = (rng.standard_normal((B, T, F)) * 3 + 5).astype(np.float32)
    x[np.arange(T)[None, :] >= lens[:, None]] = 0.0
    return x, lens.astype(np.int32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spec_augment_matches_jax_on_jax_draws(rng, name, seed):
    x, lens = batch(rng)
    jcfg = jaug.SpecAugmentConfig(**CONFIGS[name])
    cfg = augment.SpecAugmentConfig(**CONFIGS[name])
    key = jax.random.key(seed)
    want = np.asarray(jaug.spec_augment(key, jnp.asarray(x), jnp.asarray(lens), jcfg))
    draws = tuple(torch.from_numpy(d) for d in jax_draws(key, x.shape[0], cfg))
    got = augment.spec_augment(torch.from_numpy(x), torch.from_numpy(lens), cfg,
                               draws=draws).numpy()
    np.testing.assert_array_equal(got != x, want != x)  # the masks
    assert (got != x).any()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    pad = np.arange(x.shape[1])[None, :] >= lens[:, None]
    assert (got[pad] == 0.0).all()


@pytest.mark.parametrize("adaptive", [False, True])
def test_interval_masks_equal_jax_exactly(rng, adaptive):
    """The two masks alone, from the same keys, over many rows."""
    B, T = 64, 200
    lens = rng.integers(0, T + 1, size=B).astype(np.int32)
    key = jax.random.key(11)
    kw, ks = jax.random.split(key)
    if adaptive:
        widths = np.asarray(jaug._floor_ratio(0.1, jnp.asarray(lens)))
        active = np.minimum(4, np.asarray(jaug._floor_ratio(0.03, jnp.asarray(lens))))
    else:
        widths, active = np.full(B, 25, np.int32), None
    want = np.asarray(jaug._interval_mask(key, 4, jnp.asarray(widths), T, jnp.asarray(lens),
                                          None if active is None else jnp.asarray(active)))
    u = [torch.from_numpy(np.asarray(jax.random.uniform(k, (B, 4)))) for k in (kw, ks)]
    got = augment._interval_mask(u[0], u[1], torch.from_numpy(widths), T,
                                 torch.from_numpy(lens),
                                 None if active is None else torch.from_numpy(active)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def test_floor_ratio_edge_cases_match_jax():
    """float32(p) * len one ulp below an exact integer still floors to it."""
    lens = np.asarray([900, 300, 100, 7, 0, 1], np.int32)
    for p, expect in ((0.13, [117, 39, 13, 0, 0, 0]), (0.21, [189, 63, 21, 1, 0, 0]),
                      (1.0, [900, 300, 100, 7, 0, 1])):
        got = augment._floor_ratio(p, torch.from_numpy(lens)).numpy()
        np.testing.assert_array_equal(got, expect)
        np.testing.assert_array_equal(got, np.asarray(jaug._floor_ratio(p, jnp.asarray(lens))))
        assert got.dtype == np.int32


def test_draws_come_from_the_generator_in_order():
    cfg = augment.SpecAugmentConfig(n_freq_masks=2, n_time_masks=3)
    a = augment.draw_uniforms(4, cfg, torch.Generator().manual_seed(5), "cpu")
    g = torch.Generator().manual_seed(5)
    want = [torch.rand((4, 2), generator=g), torch.rand((4, 2), generator=g),
            torch.rand((4, 3), generator=g), torch.rand((4, 3), generator=g)]
    for x, w in zip(a, want):
        assert torch.equal(x, w)
    x = torch.randn(4, 50, 40)
    lens = torch.tensor([50, 30, 1, 0])
    one = augment.spec_augment(x, lens, cfg, generator=torch.Generator().manual_seed(5))
    two = augment.spec_augment(x, lens, cfg, draws=a)
    assert torch.equal(one, two)
    assert torch.equal(two[3], x[3])  # a row of length 0 is all padding


@pytest.mark.parametrize("bad,match", [({"n_freq_mask": 2}, "unknown asr.augment key"),
                                       ({"adaptive_size_ratio": 1.5}, "must be in"),
                                       ({"adaptive_number_ratio": -0.1}, "must be in")])
def test_config_errors_are_the_jax_packages(bad, match):
    for cls in (augment.SpecAugmentConfig, jaug.SpecAugmentConfig):
        with pytest.raises(ValueError, match=match) as err:
            cls.from_dict(bad)
        if cls is augment.SpecAugmentConfig:
            mine = str(err.value)
        else:
            assert str(err.value) == mine
    assert augment.SpecAugmentConfig.from_dict(None) is None
    assert augment.SpecAugmentConfig.from_dict({}) is None
