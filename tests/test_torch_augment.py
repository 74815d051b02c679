"""Port parity: the AST train augmentations and the pipeline's train path.

``jax.random`` and numpy streams never match, so the JAX draws are rebuilt
here from the JAX key, repeating the key splits of ``spec_augment``
(``dlsc_tpu/ops/augment.py:155-176``), ``mixup`` (:239-247) and
``DevicePipeline.train_batch`` (``dlsc_tpu/data/pipeline.py:139``), and the
port's apply functions are fed those draws. Tolerances: masks and one-hot
labels exact; Mixup 1e-6 absolute (the same f32 convex sums); the whole
train batch 1e-4 absolute, the eval features' bar (tests/test_torch_mel.py).
The port's own draws are checked for their ranges and rates.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.data.pipeline import DevicePipeline as JaxPipeline
from dlsc_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from dlsc_tpu.ops import augment as JA
from dlsc_tpu_torch.data.pipeline import (DevicePipeline, PipelineConfig, TrainDraws,
                                          pipeline_from_dataset_config)
from dlsc_tpu_torch.ops import augment as A

N_MELS, N_FRAMES = 128, 276   # 1-s clips at hop 160


def jax_spec_draws(key, batch, n_mels, n_frames, time_mask, freq_mask) -> A.SpecAugmentDraws:
    """The per-sample mask draws that ``dlsc_tpu.ops.augment.spec_augment``
    makes from ``key`` (length 0 where a mask does not apply)."""

    def span(k_len, k_start, dim, param):
        if not (param > 0 and dim > param):
            return jnp.zeros((), jnp.int32), jnp.zeros((), jnp.int32)
        length = jax.random.randint(k_len, (), 1, min(param, dim // 4) + 1)
        return jax.random.randint(k_start, (), 0, dim - length + 1), length

    def one(k):
        kt1, kt2, kf1, kf2 = jax.random.split(k, 4)
        return (*span(kt1, kt2, n_frames, time_mask), *span(kf1, kf2, n_mels, freq_mask))

    drawn = jax.vmap(one)(jax.random.split(key, batch))
    return A.SpecAugmentDraws(*(torch.from_numpy(np.asarray(a).astype(np.int64))
                                for a in drawn))


def jax_mixup_draws(key, batch, alpha) -> A.MixupDraws:
    """The gate, lam and partner draws of ``dlsc_tpu.ops.augment.mixup`` at
    its default gate probability."""
    k_gate, k_lam, k_perm = jax.random.split(key, 3)
    gate = jax.random.uniform(k_gate, (batch,)) < A.MIXUP_PROB
    lam = (jnp.ones((batch,)) if alpha <= 0
           else jax.random.beta(k_lam, alpha, alpha, (batch,)))
    partner = JA._random_partners(k_perm, batch)
    return A.MixupDraws(torch.from_numpy(np.array(gate)),
                        torch.from_numpy(np.array(lam, np.float32)),
                        torch.from_numpy(np.asarray(partner).astype(np.int64)))


def jax_pipeline_draws(key, cfg: PipelineConfig, batch: int, n_frames: int) -> TrainDraws:
    """The draws of ``dlsc_tpu`` ``DevicePipeline.train_batch(..., key)``, mode ast."""
    k_sa, k_mix = jax.random.split(key)
    spec = jax_spec_draws(k_sa, batch, cfg.n_mels, n_frames, cfg.time_mask, cfg.freq_mask)
    mix = jax_mixup_draws(k_mix, batch, cfg.mixup_alpha) if cfg.enable_mixup else None
    return TrainDraws(spec, mix)


def _spec(seed=0, b=4):
    return np.random.default_rng(seed).standard_normal((b, N_MELS, N_FRAMES)).astype(np.float32)


@pytest.mark.parametrize("time_mask,freq_mask", [(192, 48), (300, 16), (0, 0)])
@pytest.mark.parametrize("seed", [0, 1])
def test_spec_augment_matches_jax(time_mask, freq_mask, seed):
    """(300, 16): the time mask does not apply (T 276 <= 300); (0, 0): off."""
    spec = _spec(seed)
    key = jax.random.key(seed)
    want = np.asarray(JA.spec_augment(jnp.asarray(spec), key, time_mask, freq_mask))
    draws = jax_spec_draws(key, 4, N_MELS, N_FRAMES, time_mask, freq_mask)
    got = A.spec_augment(torch.from_numpy(spec), draws).numpy()
    np.testing.assert_array_equal(got, want)
    if time_mask > N_FRAMES or time_mask == 0:
        assert (draws.t_len == 0).all()


@pytest.mark.parametrize("alpha", [0.5, 0.0])
@pytest.mark.parametrize("seed", [0, 3])
def test_mixup_matches_jax(alpha, seed):
    b = 8
    spec = _spec(seed, b)
    labels = np.random.default_rng(seed).integers(0, 5, b)
    y = np.asarray(JA.one_hot(jnp.asarray(labels), 5))
    key = jax.random.key(seed)
    want_x, want_y = JA.mixup(jnp.asarray(spec), jnp.asarray(y), key, alpha)
    oh = A.one_hot(torch.from_numpy(labels), 5)
    np.testing.assert_array_equal(oh.numpy(), y)
    got_x, got_y = A.mixup(torch.from_numpy(spec), oh, jax_mixup_draws(key, b, alpha))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_y.sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("enable_mixup", [True, False])
def test_train_batch_matches_jax(enable_mixup):
    rng = np.random.default_rng(7)
    wave = (rng.standard_normal((4, 44_100)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 10, 4)
    kw = dict(mode="ast", num_classes=10, time_mask=192, freq_mask=48,
              enable_mixup=enable_mixup, mixup_alpha=0.5)
    key = jax.random.key(11)
    want_x, want_y = JaxPipeline(JaxPipelineConfig(**kw)).train_batch(
        jnp.asarray(wave), jnp.asarray(labels), key)
    pipe = DevicePipeline(PipelineConfig(**kw))
    draws = jax_pipeline_draws(key, pipe.cfg, 4, N_FRAMES)
    got_x, got_y = pipe.train_batch(torch.from_numpy(wave), torch.from_numpy(labels), draws)
    assert got_x.shape == want_x.shape == (4, N_MELS, N_FRAMES)
    assert not got_x.requires_grad
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-6)


def test_port_draws_ranges_and_rates():
    """The port's own draws: lengths in [1, min(param, dim // 4)], spans
    inside the axis, partners never the sample itself and uniform over the
    others, gate rate 0.25 and lam in (0, 1) with mean 0.5 (Beta(0.5, 0.5))."""
    b = 4096
    rng = np.random.default_rng(0)
    spec = A.spec_augment_draws(b, N_MELS, N_FRAMES, 192, 48, rng)
    for start, length, dim, cap in ((spec.t_start, spec.t_len, N_FRAMES, 69),
                                    (spec.f_start, spec.f_len, N_MELS, 32)):
        assert length.min() == 1 and length.max() == cap
        assert start.min() >= 0 and (start + length).max() <= dim
    off = A.spec_augment_draws(8, N_MELS, N_FRAMES, 300, 0, rng)
    assert (off.t_len == 0).all() and (off.f_len == 0).all()

    mix = A.mixup_draws(b, 0.5, rng)
    assert abs(mix.gate.float().mean().item() - 0.25) < 0.03   # > 4 sigma at b 4096
    assert ((mix.lam > 0) & (mix.lam < 1)).all()
    assert abs(mix.lam.mean().item() - 0.5) < 0.03
    assert (mix.partner != torch.arange(b)).all()
    small = np.stack([A.random_partners(4, rng) for _ in range(3000)])
    for i in range(4):  # each other sample about 1/3 of the time
        counts = np.bincount(small[:, i], minlength=4)
        assert counts[i] == 0 and (np.abs(counts[np.arange(4) != i] / 3000 - 1 / 3) < 0.05).all()
    assert (A.mixup_draws(6, 0.0, rng).lam == 1).all()


def test_augmented_spans_are_zero():
    spec = torch.ones(2, N_MELS, N_FRAMES)
    draws = A.SpecAugmentDraws(torch.tensor([0, 10]), torch.tensor([5, 0]),
                               torch.tensor([3, 0]), torch.tensor([2, 1]))
    out = A.spec_augment(spec, draws)
    assert (out[0, :, :5] == 0).all() and (out[0, 3:5, :] == 0).all()
    assert out[0].sum() == (N_MELS - 2) * (N_FRAMES - 5)
    assert (out[1, 0] == 0).all() and out[1].sum() == (N_MELS - 1) * N_FRAMES


def test_train_batch_rejects_mismatched_draws():
    pipe = DevicePipeline(PipelineConfig(mode="ast", enable_mixup=True))
    draws = DevicePipeline(PipelineConfig(mode="ast")).draw(2, 44_100, np.random.default_rng(0))
    with pytest.raises(ValueError, match="enable_mixup"):
        pipe.train_batch(torch.zeros(2, 44_100), torch.zeros(2, dtype=torch.long), draws)


def test_pipeline_from_dataset_config_train_fields():
    pipe = pipeline_from_dataset_config({
        "preprocessing_mode": "ast", "num_classes": 10,
        "augment": {"time_mask": 192, "freq_mask": False},
        "enable_mixup": True, "mixup_alpha": 0.2})
    c = pipe.cfg
    assert (c.time_mask, c.freq_mask, c.enable_mixup, c.mixup_alpha) == (192, 0, True, 0.2)
    with pytest.raises(ValueError, match="time_mask"):
        pipeline_from_dataset_config({"preprocessing_mode": "ast",
                                      "augment": {"time_mask": True}})
