"""Port parity: EnvNet-v2, the spectrogram CNN and LEAF, their pipelines and
augmentations, BatchNorm, the converter, the train and eval steps, serving
and SWA's BatchNorm refresh, against the JAX package on the CPU.

``jax.random`` and numpy streams never match, so the JAX draws are rebuilt
here from the JAX key, repeating the key splits of
``dlsc_tpu/data/pipeline.py`` (``train_batch`` :129-139, :147-150) and of
the augmentations (``dlsc_tpu/ops/augment.py``), as
``tests/test_torch_augment.py`` does for AST. Small shapes: EnvNet-v2 on
30 000-sample inputs (its trunk ends at (10, 2, 256)), the CNN at 224², LEAF
with 8 filters of 101 taps. Tolerances, each with its reason (f32 on both
sides):

- crops, ``multi_crop``, flips and translation, one-hot labels: exact (the
  same gathers);
- time stretch, gain shift, BC mixing (waves and soft labels) and the whole
  envnet_v2 train batch: 1e-6 absolute (the same f32 formulas; sums and
  ``pow`` may round differently by an ulp);
- the resize: its weight matrices equal ``jax.image.scale_and_translate``'s
  to 1e-7; applied to an image, within 1e-6 normalised by the largest
  |value| of the exact (f64) product, and within 2e-5 of
  ``jax.image.resize``, whose own f32 contraction on the CPU is up to
  1.4e-5 off the exact product (measured at 300 → 224);
- the CNN features (the plain mel → dB → resize → /0.5) against the JAX
  eval pipeline: 2e-5 normalised (the resize's bar; the dB values
  themselves differ by up to 1e-3 absolute between the two f32 FFTs,
  ``tests/test_torch_mel.py``);
- the models' eval forward: 1e-4 normalised; train mode with dropout off:
  logits 1e-4 normalised and the updated batch statistics within 1e-5
  (``_stats_err``: a running mean over its layer's largest running std, the
  size of the terms it sums; a running variance over its largest value;
  the biased batch variance on both sides); for LEAF those bars hold
  against an f64 run of the port, and JAX's own f32 rounding, amplified by
  its MLP's BatchNorms, allows 5e-4 and 5e-5 against JAX (see the test);
- one train step (SGD with momentum and L2, the same draws, dropout off):
  loss 1e-5 relative in f32; parameters 1e-5 of their change and BatchNorm
  statistics 1e-6, both sides in f64 (see the test for why);
- the multi-crop eval step and ``make_infer`` against the JAX eval step and
  ``dlsc_tpu.serving.make_infer``: 1e-5 (logits normalised, probabilities
  absolute);
- SWA's BatchNorm refresh against a pass computed by hand: 1e-6 normalised
  (the same f32 statistics, another reduction order).
"""

import copy

import flax
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.data.pipeline import DevicePipeline as JaxPipeline
from dlsc_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from dlsc_tpu.models.cnn_esc50 import CNN_ESC50 as JaxCNN
from dlsc_tpu.models.envnet_v2 import EnvNetV2 as JaxEnvNet
from dlsc_tpu.models.leaf import LeafModel as JaxLeaf
from dlsc_tpu.ops import augment as JA
from dlsc_tpu.serving import make_infer as jax_make_infer
from dlsc_tpu.train import losses as JL
from dlsc_tpu.train import metrics as JM
from dlsc_tpu.train import optim as JO
from dlsc_tpu.train.state import TrainState as JaxTrainState
from dlsc_tpu.train.steps import make_eval_step as jax_make_eval_step
from dlsc_tpu.train.steps import make_train_step as jax_make_train_step
from chip_smoke import BiasTerms
from dlsc_tpu_torch.data.datamodule import ESC50DataModule
from dlsc_tpu_torch.data.pipeline import (DevicePipeline, PipelineConfig, WaveDraws,
                                          pipeline_from_dataset_config, resize_bilinear,
                                          resize_matrix_np)
from dlsc_tpu_torch.data.synthetic import make_synthetic_dataset
from dlsc_tpu_torch.models import cnn_esc50, leaf
from dlsc_tpu_torch.models.cnn_esc50 import CNN_ESC50
from dlsc_tpu_torch.models.convert import params_from_jax
from dlsc_tpu_torch.models.envnet_v2 import EnvNetV2, trunk_shape
from dlsc_tpu_torch.models.layers import BatchNorm
from dlsc_tpu_torch.models.leaf import LeafModel
from dlsc_tpu_torch.ops.dropout_draw import Draw, dropout
from dlsc_tpu_torch.ops import augment as A
from dlsc_tpu_torch.serving import export_model, load_exported, make_infer
from dlsc_tpu_torch.train import losses as L
from dlsc_tpu_torch.train import metrics as M
from dlsc_tpu_torch.train import optim as O
from dlsc_tpu_torch.train.loop import Trainer
from dlsc_tpu_torch.train.state import TrainState
from dlsc_tpu_torch.train.steps import make_eval_step, make_train_step

C_ = 5
SR = 44_100
ENV_IN = 30_000          # EnvNet-v2's input in these tests
LEAF_KW = dict(n_filters=8, kernel_size=101)
LEAF_T = 16_000
LEAF_B = 8     # LEAF's MLP BatchNorms over B rows: see test_train_forward_...
B = 3


def norm_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, flax.core.unfreeze(tree))


# ---- the JAX draws, rebuilt from the key ------------------------------------------

def jax_wave_draws(key, cfg: PipelineConfig, batch: int, num_samples: int) -> WaveDraws:
    """The draws of ``dlsc_tpu`` ``DevicePipeline.train_batch(..., key)``, mode envnet_v2."""
    k_crop, k_ts, k_gs, k_bc = jax.random.split(key, 4)
    padded, window = num_samples + 2 * cfg.padding_samples, cfg.window_samples
    crop = (jax.random.randint(k_crop, (batch,), 0, padded - window + 1) if padded > window
            else jnp.zeros((batch,), jnp.int32))

    def gated(k, low, high):
        k_gate, k_val = jax.random.split(k)
        return A.GatedDraws(_t(jax.random.uniform(k_gate, (batch,)) < 0.5),
                            _t(jax.random.uniform(k_val, (batch,), minval=low, maxval=high)))

    bc = None
    if cfg.enable_bc_mixing:
        k_r, k_perm = jax.random.split(k_bc)
        bc = A.BCDraws(_t(jax.random.uniform(k_r, (batch,))),
                       _t(JA._random_partners(k_perm, batch)).long())
    return WaveDraws(_t(crop).long(),
                     gated(k_ts, *cfg.time_stretch) if cfg.time_stretch else None,
                     gated(k_gs, *cfg.gain_shift) if cfg.gain_shift else None, bc)


def jax_flip_draws(key, batch: int, height: int, width: int,
                   translate: float = 0.1) -> A.FlipDraws:
    """The draws of ``dlsc_tpu.ops.augment.image_flip_translate``."""
    kh, kv, kx, ky = jax.random.split(key, 4)
    mx, my = int(translate * width), int(translate * height)
    return A.FlipDraws(_t(jax.random.bernoulli(kh, 0.5, (batch,))),
                       _t(jax.random.bernoulli(kv, 0.5, (batch,))),
                       _t(jax.random.randint(kx, (batch,), -mx, mx + 1)).long(),
                       _t(jax.random.randint(ky, (batch,), -my, my + 1)).long())


def _wave(seed=0, b=B, t=ENV_IN, scale=0.3) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal((b, t)) * scale).astype(np.float32)


def _labels(seed=0, b=B) -> np.ndarray:
    return np.random.default_rng(seed + 100).integers(0, C_, b)


# ---- augmentations and crops -------------------------------------------------------

@pytest.mark.parametrize("n,target", [(100, 100), (70, 256), (300, 128), (301, 128)])
def test_pad_or_trim_matches_jax(n, target):
    x = _wave(0, 2, n)
    np.testing.assert_array_equal(A.pad_or_trim(torch.from_numpy(x), target).numpy(),
                                  np.asarray(JA.pad_or_trim(jnp.asarray(x), target)))


@pytest.mark.parametrize("n,window", [(50_000, 30_000), (30_001, 30_000), (20_000, 30_000)])
def test_crops_match_jax(n, window):
    """Random crops at the JAX starts, the centre crop and ten crops (the
    starts at floor(linspace)), a clip shorter than the window padded."""
    x = _wave(1, 4, n)
    key = jax.random.key(3)
    starts = (jax.random.randint(key, (4,), 0, n - window + 1) if n > window
              else jnp.zeros((4,), jnp.int32))
    np.testing.assert_array_equal(
        A.random_crop(torch.from_numpy(x), _t(starts).long(), window).numpy(),
        np.asarray(JA.random_crop(jnp.asarray(x), key, window)))
    np.testing.assert_array_equal(A.center_crop(torch.from_numpy(x), window).numpy(),
                                  np.asarray(JA.center_crop(jnp.asarray(x), window)))
    for n_crops in (10, 3):
        got = A.multi_crop(torch.from_numpy(x), window, n_crops)
        assert got.shape == (4, n_crops, window)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(JA.multi_crop(jnp.asarray(x), window, n_crops)))


@pytest.mark.parametrize("seed", [0, 1])
def test_time_stretch_and_gain_match_jax(seed):
    x = _wave(seed, 6, 20_000)
    key = jax.random.key(seed)
    k_gate, k_val = jax.random.split(key)
    for low, high, ours, theirs in ((0.8, 1.25, A.time_stretch, JA.time_stretch),
                                    (-12.0, 12.0, A.gain_shift, JA.gain_shift)):
        draws = A.GatedDraws(_t(jax.random.uniform(k_gate, (6,)) < 0.5),
                             _t(jax.random.uniform(k_val, (6,), minval=low, maxval=high)))
        got = ours(torch.from_numpy(x), draws).numpy()
        want = np.asarray(theirs(jnp.asarray(x), key, low, high))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        assert 0 < draws.gate.sum() < 6   # both branches taken at these seeds


def test_image_flip_translate_matches_jax():
    img = np.random.default_rng(2).standard_normal((8, 40, 30)).astype(np.float32)
    key = jax.random.key(7)
    got = A.image_flip_translate(torch.from_numpy(img), jax_flip_draws(key, 8, 40, 30))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JA.image_flip_translate(jnp.asarray(img), key)))


@pytest.mark.parametrize("seed", [0, 4])
def test_bc_mix_matches_jax(seed):
    """Waves and soft labels, with same-class partners (left unmixed) among
    them, a silent clip (-80 dB) and a loud one (the > 10 dB adjustment)."""
    b = 8
    x = _wave(seed, b, 5000)
    x[2] = 0.0
    x[5] *= 20.0
    labels = np.array([0, 0, 1, 1, 2, 3, 4, 0])
    y = np.array(JA.one_hot(jnp.asarray(labels), C_))
    key = jax.random.key(seed)
    want_x, want_y = JA.bc_mix(jnp.asarray(x), jnp.asarray(y), key)
    k_r, k_perm = jax.random.split(key)
    draws = A.BCDraws(_t(jax.random.uniform(k_r, (b,))), _t(JA._random_partners(k_perm, b)).long())
    got_x, got_y = A.bc_mix(torch.from_numpy(x), torch.from_numpy(y), draws)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-6)
    same = labels == labels[draws.partner.numpy()]
    assert same.any() and (got_x.numpy()[same] == x[same]).all()


ENV_CFGS = {
    "plain": dict(),
    "bc": dict(enable_bc_mixing=True),
    "all": dict(enable_bc_mixing=True, time_stretch=(0.8, 1.25), gain_shift=(-6.0, 6.0)),
}


def _env_cfg(**kw) -> dict:
    return dict(mode="envnet_v2", num_classes=C_, window_length=ENV_IN / SR, padding_ratio=0.5,
                **kw)


@pytest.mark.parametrize("which", sorted(ENV_CFGS))
def test_envnet_train_batch_matches_jax(which):
    kw = _env_cfg(**ENV_CFGS[which])
    wave, labels = _wave(5, 4, 25_000), _labels(5, 4)
    key = jax.random.key(11)
    want_x, want_y = JaxPipeline(JaxPipelineConfig(**kw)).train_batch(
        jnp.asarray(wave), jnp.asarray(labels), key)
    pipe = DevicePipeline(PipelineConfig(**kw))
    draws = jax_wave_draws(key, pipe.cfg, 4, 25_000)
    got_x, got_y = pipe.train_batch(torch.from_numpy(wave), torch.from_numpy(labels), draws)
    assert got_x.shape == want_x.shape == (4, pipe.cfg.window_samples)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), rtol=0, atol=1e-6)


@pytest.mark.parametrize("multi", [False, True])
def test_envnet_eval_batch_matches_jax(multi):
    kw = _env_cfg(multi_crop_test=multi, test_crops=10)
    wave = (_wave(6, 2, 25_000) * 20000).astype(np.int16)   # the PCM16 wire format
    got = DevicePipeline(PipelineConfig(**kw)).eval_batch(torch.from_numpy(wave))
    want, _ = JaxPipeline(JaxPipelineConfig(**kw)).eval_batch(jnp.asarray(wave),
                                                            jnp.zeros((2,), jnp.int32))
    assert got.shape == want.shape == ((2, 10, ENV_IN) if multi else (2, ENV_IN))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(128, 431), (128, 63), (300, 224)])
def test_resize_matches_jax(shape):
    """``jax.image.resize(..., "bilinear")`` antialiases a shrinking axis:
    431 frames → 224 shrinks, 128 mels → 224 grows."""
    from jax._src.image import scale as jscale

    img = np.random.default_rng(3).standard_normal((2, *shape)).astype(np.float32) * 30
    mats = []
    for m in shape:
        w = resize_matrix_np(m, 224) if m != 224 else np.eye(224, dtype=np.float32)
        if m != 224:
            want_w = np.asarray(jscale.compute_weight_mat(
                m, 224, 224 / m, 0.0, jscale._fill_triangle_kernel, True)).T
            np.testing.assert_allclose(w, want_w, rtol=0, atol=1e-7)
        mats.append(w.astype(np.float64))
    exact = mats[0] @ img.astype(np.float64) @ mats[1].T
    got = resize_bilinear(torch.from_numpy(img), 224, 224).numpy()
    want = np.asarray(jax.image.resize(jnp.asarray(img), (2, 224, 224), method="bilinear"))
    assert norm_err(got, exact) < 1e-6
    assert norm_err(got, want) < 2e-5


def test_cnn_features_and_train_batch_match_jax():
    kw = dict(mode="cnn_esc50", num_classes=C_)
    wave, labels = _wave(7, 2, SR), _labels(7, 2)
    pipe, jpipe = DevicePipeline(PipelineConfig(**kw)), JaxPipeline(JaxPipelineConfig(**kw))
    got = pipe.eval_batch(torch.from_numpy(wave))
    want, _ = jpipe.eval_batch(jnp.asarray(wave), jnp.asarray(labels))
    assert got.shape == want.shape == (2, 224, 224)
    assert norm_err(got.numpy(), want) < 2e-5
    key = jax.random.key(9)
    want_x, want_y = jpipe.train_batch(jnp.asarray(wave), jnp.asarray(labels), key)
    got_x, got_y = pipe.train_batch(torch.from_numpy(wave), torch.from_numpy(labels),
                                    jax_flip_draws(key, 2, 224, 224))
    assert norm_err(got_x.numpy(), want_x) < 2e-5
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


def test_raw_mode_and_unknown_mode():
    pipe = DevicePipeline(PipelineConfig(mode="raw", num_classes=C_))
    wave = (_wave(8, 2, 1000) * 20000).astype(np.int16)
    x, y = pipe.train_batch(torch.from_numpy(wave), torch.tensor([1, 3]),
                            pipe.draw(2, 1000, np.random.default_rng(0)))
    np.testing.assert_array_equal(x.numpy(), wave.astype(np.float32) / 32768.0)
    assert y.argmax(-1).tolist() == [1, 3]
    with pytest.raises(ValueError, match="preprocessing_mode"):
        DevicePipeline(PipelineConfig(mode="mfcc"))


def test_port_wave_draws_ranges_and_rates():
    """The port's own draws: crop starts inside the padded clip, gates at
    rate 0.5, factors in range, flips at 0.5 and shifts within ±10%."""
    cfg = PipelineConfig(**_env_cfg(enable_bc_mixing=True, time_stretch=(0.8, 1.25),
                                    gain_shift=(-6.0, 6.0)))
    pipe, n = DevicePipeline(cfg), 4096
    d = pipe.draw(n, 25_000, np.random.default_rng(0))
    assert d.crop.min() >= 0 and d.crop.max() <= 25_000 + 2 * cfg.padding_samples - ENV_IN
    for g, (lo, hi) in ((d.stretch, cfg.time_stretch), (d.gain, cfg.gain_shift)):
        assert abs(g.gate.float().mean().item() - 0.5) < 0.04
        assert lo <= g.value.min() and g.value.max() <= hi
    assert ((d.bc.r >= 0) & (d.bc.r < 1)).all() and (d.bc.partner != torch.arange(n)).all()
    f = DevicePipeline(PipelineConfig(mode="cnn_esc50")).draw(n, SR, np.random.default_rng(1))
    assert abs(f.hflip.float().mean().item() - 0.5) < 0.04
    assert f.dx.min() == -22 and f.dx.max() == 22 and f.dy.abs().max() == 22


def test_train_batch_rejects_mismatched_draws():
    pipe = DevicePipeline(PipelineConfig(**_env_cfg(enable_bc_mixing=True)))
    other = DevicePipeline(PipelineConfig(**_env_cfg())).draw(2, 25_000,
                                                              np.random.default_rng(0))
    with pytest.raises(ValueError, match="enable_bc_mixing"):
        pipe.train_batch(torch.zeros(2, 25_000), torch.zeros(2, dtype=torch.long), other)


def test_pipeline_from_dataset_config_wave_fields():
    c = pipeline_from_dataset_config({
        "preprocessing_mode": "envnet_v2", "num_classes": 10, "enable_bc_mixing": True,
        "preprocessing_config": {"window_length": 1.5, "padding_ratio": 0.25,
                                 "multi_crop_test": True, "test_crops": 4,
                                 "augment": {"time_stretch": [0.8, 1.25],
                                             "gain_shift": None}}}).cfg
    assert (c.window_samples, c.padding_samples, c.multi_crop_test, c.test_crops,
            c.time_stretch, c.gain_shift, c.enable_bc_mixing) == (
        66_150, 16_537, True, 4, (0.8, 1.25), None, True)


# ---- BatchNorm -------------------------------------------------------------------

def test_batchnorm_is_flax_batchnorm():
    """Train mode: normalised by the biased batch variance, running stats
    0.9·old + 0.1·batch with the biased variance (nn.BatchNorm1d would use
    the unbiased one); eval mode: the running stats."""
    x = np.random.default_rng(0).standard_normal((6, 4, 7)).astype(np.float32) * 3 + 1
    jbn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    xj = jnp.asarray(x.transpose(0, 2, 1))   # channels last
    v = jbn.init(jax.random.key(0), xj)
    want, mut = jbn.apply(v, xj, mutable=["batch_stats"])
    bn = BatchNorm(4).train()
    got = bn(torch.from_numpy(x)).detach()
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1), atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]), rtol=1e-6, atol=1e-7)
    assert bn.num_batches_tracked.item() == 1
    jeval = fnn.BatchNorm(use_running_average=True, momentum=0.9, epsilon=1e-5)
    want_eval = jeval.apply({**v, "batch_stats": mut["batch_stats"]}, xj)
    np.testing.assert_allclose(bn.eval()(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(want_eval).transpose(0, 2, 1), atol=1e-5)


# ---- the models --------------------------------------------------------------------

def _dropout_zero(monkeypatch):
    """Flax's Dropout at rate 0 (a test-side patch: the CNN's and LEAF's
    rates are fixed in the JAX modules) and the port's module rates at 0."""
    cls = fnn.Dropout
    monkeypatch.setattr(fnn, "Dropout",
                        lambda rate, deterministic=None: cls(0.0, deterministic=deterministic))
    monkeypatch.setattr(cnn_esc50, "DROPOUT", 0.0)
    monkeypatch.setattr(leaf, "DROPOUT", 0.0)


def _family(name):
    """(JAX module, port module, input) of a family at the tests' size; the
    EnvNet-v2s without dropout so that a train step can be compared."""
    rng = np.random.default_rng(12)
    if name == "envnet_v2":
        return (JaxEnvNet(num_classes=C_, dropout=0.0),
                EnvNetV2(num_classes=C_, dropout=0.0, input_samples=ENV_IN),
                (rng.standard_normal((B, ENV_IN)) * 0.3).astype(np.float32))
    if name == "cnn_esc50":
        return (JaxCNN(num_classes=C_), CNN_ESC50(num_classes=C_),
                rng.standard_normal((B, 224, 224)).astype(np.float32))
    return (JaxLeaf(num_classes=C_, **LEAF_KW), LeafModel(num_classes=C_, **LEAF_KW),
            (rng.standard_normal((LEAF_B, LEAF_T)) * 0.3).astype(np.float32))


FAMILIES = ("envnet_v2", "cnn_esc50", "leaf")


def _jax_train_apply(jm, v, x):
    """(logits, updated batch stats) of one jitted train-mode forward."""
    out, mut = jax.jit(lambda v, x: jm.apply(v, x, train=True, rngs={"dropout": jax.random.key(3)},
                                             mutable=["batch_stats"]))(v, jnp.asarray(x))
    return np.asarray(out), _np(mut["batch_stats"])


def _stats_err(got: dict, want: dict) -> float:
    """BatchNorm statistics: a running mean's error over the largest running
    std of its layer (a mean is a sum of terms of that size), a running
    variance's over its largest value."""
    errs = []
    for k, v in want.items():
        if k.endswith("running_mean"):
            std = want[k[:-4] + "var"].sqrt().max().item()
            errs.append((got[k] - v).abs().max().item() / std)
        elif k.endswith("running_var"):
            errs.append(norm_err(got[k].numpy(), v.numpy()))
    return max(errs)


@pytest.fixture(scope="module")
def families():
    """Per family: the JAX module, its variables (batch stats from one
    train-mode pass, so that eval mode reads non-trivial ones), the port
    module loaded from them, and the input."""
    out = {}
    for name in FAMILIES:
        jm, tm, x = _family(name)
        v = _np(jax.jit(jm.init, static_argnames="train")(
            {"params": jax.random.key(0), "dropout": jax.random.key(1)}, jnp.asarray(x),
            train=False))
        _, v["batch_stats"] = _jax_train_apply(jm, v, x)
        tm.load_state_dict(params_from_jax(v, tm))
        out[name] = (jm, v, tm, x)
    return out


@pytest.mark.parametrize("name", FAMILIES)
def test_eval_forward_matches_jax(name, families):
    jm, v, tm, x = families[name]
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, train=False))(v, jnp.asarray(x)))
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (x.shape[0], C_)
    assert norm_err(got.numpy(), want) < 1e-4


@pytest.mark.parametrize("name", FAMILIES)
def test_train_forward_and_batch_stats_match_jax(name, families, monkeypatch):
    """LEAF's first MLP BatchNorm sees inputs whose batch mean is up to ~75x
    their spread (mean-pooled features share a large common part), so it
    amplifies upstream f32 rounding: there JAX's f32 run is 2.5e-4 from an
    f64 run of the same model at batch 8 (1.1e-3 at batch 3), its batch
    statistics 1.2e-5; the port's 2e-5 and 1.6e-6 (measured). LEAF is
    therefore held to an f64 run of the port at 1e-4 (statistics 1e-5) and
    to JAX at 5e-4 (5e-5); EnvNet-v2 and the CNN to JAX at 1e-4 (1e-5)."""
    _dropout_zero(monkeypatch)
    jm, v, tm, x = families[name]
    want, stats = _jax_train_apply(jm, v, x)
    model = copy.deepcopy(tm).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x), dropout_seed=0)
    sd = model.state_dict()
    want_sd = params_from_jax({"params": v["params"], "batch_stats": stats}, model)
    if name == "leaf":
        f64 = copy.deepcopy(tm).double().train()
        f64.dtype = torch.float64
        with torch.no_grad():
            exact = f64(torch.from_numpy(x).double(), dropout_seed=0)
        assert norm_err(got.numpy(), exact.numpy()) < 1e-4
        assert _stats_err(sd, {k: b.float() for k, b in f64.state_dict().items()}) < 1e-5
        assert norm_err(got.numpy(), want) < 5e-4
        assert _stats_err(sd, want_sd) < 5e-5
    else:
        assert norm_err(got.numpy(), want) < 1e-4
        assert _stats_err(sd, want_sd) < 1e-5
    assert all(b.item() == 1 for k, b in sd.items() if k.endswith("num_batches_tracked"))


@pytest.mark.parametrize("name", FAMILIES)
def test_converter_names_shapes_and_flatten(name, families):
    """Every Flax leaf (params and batch stats) has one port key with the
    moved shape, and the port's keys beyond them are the counters. The
    first dense layer reads the trunk in NHWC order, unpermuted."""
    jm, v, tm, _ = families[name]
    names = tm.flax_names()
    leaves = {"/".join(str(k.key) for k in path): leaf for coll in ("params", "batch_stats")
              for path, leaf in jax.tree_util.tree_leaves_with_path(v[coll])}
    assert set(leaves) == set(names)
    sd = tm.state_dict()
    assert set(sd) - set(names.values()) == {k for k in sd if k.endswith("num_batches_tracked")}
    for flax_key, key in names.items():
        shape = leaves[flax_key].shape
        moved = shape[::-1] if len(shape) == 2 else (
            (shape[3], shape[2], shape[0], shape[1]) if len(shape) == 4 else
            (shape[2], shape[1], shape[0]) if len(shape) == 3 else shape)
        assert tuple(sd[key].shape) == moved, flax_key
    if name == "envnet_v2":
        h, w, c = trunk_shape(ENV_IN)
        assert (h, w, c) == (10, 2, 256)
        np.testing.assert_array_equal(tm.fc[0].weight.detach().numpy(),
                                      v["params"]["Dense_0"]["kernel"].T)


def test_port_dropout_rate_and_seed(families):
    """The port's dropout keeps ~1 - rate and scales by 1/(1 - rate); one
    seed gives one set of masks, another seed another."""
    for site, rate in enumerate((0.5, 0.3)):
        kept = dropout(torch.ones(200_000), rate, Draw(0), site)
        assert abs((kept > 0).float().mean().item() - (1 - rate)) < 0.005
        assert torch.allclose(kept[kept > 0], torch.tensor(1 / (1 - rate)))
    for name in FAMILIES:
        _, _, tm, x = families[name]
        model = copy.deepcopy(tm).train()
        if name == "envnet_v2":
            model.rate = 0.5
        with torch.no_grad():
            a, b, c = (model(torch.from_numpy(x), dropout_seed=s) for s in (1, 1, 2))
        assert torch.equal(a, b) and not torch.equal(a, c), name


def _jax_state(jm, v, tx, seed=5):
    return JaxTrainState.create(apply_fn=jm.apply, params=v["params"],
                                batch_stats=v["batch_stats"], tx=tx, rng=jax.random.key(seed))


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_jax(name, families, monkeypatch):
    """One step against ``dlsc_tpu.train.steps.make_train_step`` with the
    same draws, dropout off: EnvNet-v2 with BC mixing and KLDiv, the CNN on
    its images, LEAF (at batch 8, see
    ``test_train_forward_and_batch_stats_match_jax``) on padded crops; SGD
    with momentum and L2 (which moves PCEN's unused α on both sides), no
    clip. The port's f32 step gives JAX's loss within 1e-5 relative. The
    parameters and statistics after the update are compared in f64 on both
    sides (``jax.enable_x64``; each package's f32 heads as they are): on
    the CPU, JAX's own f32 gradients of these models are up to 29%
    (EnvNet-v2's ``Dense_0``), 1.4% (the CNN) and 0.25% (LEAF) off its f64
    ones, where the port's f32 gradients are within 1e-5 of f64 (measured),
    and a max pool's choice can flip under a 1e-7 change of its input. Each
    parameter is held by its largest change to 1e-5 (measured up to 9e-7:
    the f32 heads), a pre-BatchNorm bias (its gradient 0 in exact
    arithmetic) by lr x the size of its gradient's terms
    (``chip_smoke.BiasTerms``); the statistics to 1e-6 (``_stats_err``).
    The CNN's features differ by up to 2e-5 between the two packages' f32
    FFTs (held by ``test_cnn_features_and_train_batch_match_jax``), which its
    gradients' cancelling sums amplify to 3.6% of a BatchNorm bias's change,
    so its f64 step is fed the JAX pipeline's features."""
    _dropout_zero(monkeypatch)
    jm, v, tm, _ = families[name]
    if name == "envnet_v2":
        kw, n, jcrit, crit = _env_cfg(enable_bc_mixing=True), 25_000, JL.KLDivLoss(), L.KLDivLoss()
    elif name == "cnn_esc50":
        kw, n, jcrit, crit = dict(mode="cnn_esc50", num_classes=C_), SR, \
            JL.CrossEntropyLoss(), L.CrossEntropyLoss()
    else:
        kw, n, jcrit, crit = dict(_env_cfg(), window_length=LEAF_T / SR), 12_000, \
            JL.CrossEntropyLoss(), L.CrossEntropyLoss()
    b = LEAF_B if name == "leaf" else B
    wave, labels = _wave(13, b, n), np.arange(b) % 2
    pipe = DevicePipeline(PipelineConfig(**kw))
    opt = dict(lr=0.05, momentum=0.9, weight_decay=1e-2)
    with jax.enable_x64(True):
        jm64 = jm.clone(dtype=jnp.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), v)
        tx, _ = JO.build_optimizer(JO.sgd(**opt), None, 1, None)
        jstate = JaxTrainState.create(apply_fn=jm64.apply, params=v64["params"],
                                      batch_stats=v64["batch_stats"], tx=tx,
                                      rng=jax.random.key(5))
        k_pipe = jax.random.split(jstate.rng, 3)[1]   # dlsc_tpu/train/steps.py:49
        draws = (jax_flip_draws(k_pipe, b, 224, 224) if name == "cnn_esc50"
                 else jax_wave_draws(k_pipe, pipe.cfg, b, n))
        jpipe = JaxPipeline(JaxPipelineConfig(**kw))
        jstate, _, jloss = jax.jit(jax_make_train_step(jpipe, jcrit))(
            jstate, JM.MetricState.create(C_), jnp.asarray(wave), jnp.asarray(labels))
        if name == "cnn_esc50":
            jfeats = np.array(jpipe._cnn_features(jnp.asarray(wave)))
        jstate = _np(jstate.params), _np(jstate.batch_stats)

    def port_step(pipe, dtype):
        model = copy.deepcopy(tm).to(dtype)
        model.dtype = dtype
        state = TrainState.create(model, O.sgd(**opt), None, 1)
        terms = BiasTerms(model)
        _, _, loss = make_train_step(pipe, crit)(state, M.MetricState.create(C_),
                                                 torch.from_numpy(wave),
                                                 torch.from_numpy(labels), draws, 0)
        terms.remove()
        assert loss.item() == pytest.approx(float(jloss), rel=1e-5)
        return model, terms

    port_step(pipe, torch.float32)   # the f32 step's loss
    if name == "cnn_esc50":   # the parameters from the JAX pipeline's features
        monkeypatch.setattr(pipe, "_cnn_features", lambda w: torch.from_numpy(jfeats))
    model, terms = port_step(pipe, torch.float64)
    before = {k: v.double() for k, v in tm.state_dict().items()}
    sd = model.state_dict()
    want = params_from_jax({"params": jstate[0], "batch_stats": jstate[1]}, model)
    assert len(terms.scales) == sum(isinstance(m, BatchNorm) for m in model.modules())
    errs = {}
    for k, p in model.named_parameters():
        scale = (opt["lr"] * terms.scales[k] if k in terms.scales
                 else (want[k] - before[k]).abs().max().item())
        errs[k] = (p.detach() - want[k]).abs().max().item() / scale
    assert max(errs.values()) < 1e-5, sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    assert _stats_err(sd, want) < 1e-6
    if name == "leaf":
        assert not torch.equal(model.pcen.alpha, tm.pcen.alpha)


def _env_serving(families, multi: bool):
    jm, v, tm, _ = families["envnet_v2"]
    kw = _env_cfg(multi_crop_test=multi, test_crops=4)
    return jm, v, tm, JaxPipeline(JaxPipelineConfig(**kw)), DevicePipeline(PipelineConfig(**kw))


def test_multi_crop_eval_step_matches_jax(families):
    jm, v, tm, jpipe, pipe = _env_serving(families, multi=True)
    wave, labels = _wave(14, B, 25_000), _labels(14)
    mask = np.array([True, False, True])
    jstate = _jax_state(jm, v, JO.build_optimizer(JO.sgd(lr=0.1), None, 1, None)[0])
    jms, jlogits = jax.jit(jax_make_eval_step(jpipe, JL.CrossEntropyLoss()))(
        jstate, JM.MetricState.create(C_), jnp.asarray(wave), jnp.asarray(labels),
        jnp.asarray(mask))
    state = TrainState.create(copy.deepcopy(tm), O.sgd(lr=0.1), None, 1)
    ms, logits = make_eval_step(pipe, L.CrossEntropyLoss())(
        state, M.MetricState.create(C_), torch.from_numpy(wave), torch.from_numpy(labels),
        torch.from_numpy(mask))
    assert logits.shape == (B, C_)
    assert norm_err(logits.numpy(), jlogits) < 1e-5
    np.testing.assert_array_equal(ms.confmat.numpy(), np.asarray(jms.confmat))


@pytest.mark.parametrize("multi", [True, False])
def test_make_infer_matches_jax(families, multi):
    jm, v, tm, jpipe, pipe = _env_serving(families, multi)
    wave = _wave(15, 2, 25_000)
    want = np.asarray(jax.jit(jax_make_infer(jm, jpipe))(v, jnp.asarray(wave)))
    got = make_infer(tm.eval(), pipe)(torch.from_numpy(wave)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_export_keeps_counter_dtypes(families, tmp_path):
    """The artifact keeps BatchNorm's int64 counters as int64 (and the
    weights in f32); the reloaded EnvNet-v2 gives the same outputs."""
    _, _, tm, x = families["envnet_v2"]
    model = copy.deepcopy(tm)
    model.train()(torch.from_numpy(x), dropout_seed=0)   # counters at 1
    model.eval()
    pipe = DevicePipeline(PipelineConfig(**_env_cfg()))
    art = export_model(model, pipe, tmp_path / "art", batch=2, clip_samples=25_000)
    saved = torch.load(art / "state_dict.pt", weights_only=True)
    assert saved["front.0.bn.num_batches_tracked"].dtype == torch.int64
    serve = load_exported(art, device="cpu")
    counters = [b for k, b in serve.model.state_dict().items()
                if k.endswith("num_batches_tracked")]
    assert counters and all(c.dtype == torch.int64 and c.item() == 1 for c in counters)
    wave = _wave(16, 2, 25_000)
    np.testing.assert_array_equal(serve(wave),
                                  make_infer(model, pipe)(torch.from_numpy(wave)).numpy())
    with pytest.raises(ValueError, match="rebuild"):
        export_model(torch.nn.Linear(2, 2), pipe, tmp_path / "bad")


def test_swa_refresh_is_a_momentum_pass(tmp_path):
    """``Trainer.fit`` with SWA on a tiny EnvNet-v2: after fit, the running
    statistics equal a pass computed here by hand over the train batches
    (each BatchNorm's input captured by a hook; 0.9·old + 0.1·(batch mean,
    biased variance)), from the statistics the last epoch left, with the
    averaged weights and the pipeline's draws of the same generator."""
    make_synthetic_dataset(tmp_path / "data", num_classes=C_, clips_per_class_per_fold=2,
                           clip_samples=20_000, seed=0)
    win = 0.7   # 30 869 samples, the least EnvNet-v2 takes is ~30 000
    dm_kw = dict(root=str(tmp_path / "data"), num_classes=C_, batch_size=4, val_split=0.2,
                 preprocessing_mode="envnet_v2", enable_bc_mixing=True,
                 preprocessing_config={"window_length": win})
    snaps = {}
    model = EnvNetV2(num_classes=C_, input_samples=int(win * SR),
                     generator=torch.Generator().manual_seed(0))

    class Snapshot:
        def on_validation_epoch_end(self, trainer, epoch, metrics):
            snaps[epoch] = copy.deepcopy(model.state_dict())

    trainer = Trainer(accelerator="cpu", max_epochs=2, limit_train_batches=2, seed=0,
                      checkpoint_dir=tmp_path / "ck", enable_checkpointing=False)
    dm = ESC50DataModule(**dm_kw)
    trainer.fit(model, dm, O.sgd(lr=0.01), None, criterion=L.KLDivLoss(),
                callbacks=[Snapshot()], swa_cfg={"swa_epoch_start": 0})
    got = {k: b for k, b in trainer.state.model.state_dict().items() if "running" in k}

    # by hand: the averaged weights, the last epoch's statistics, the same draws
    sd = snaps[1]
    ref = EnvNetV2(num_classes=C_, input_samples=int(win * SR))
    ref.load_state_dict({k: (sd[k] + snaps[0][k]) / 2 if k in dict(model.named_parameters())
                         else sd[k] for k in sd})
    ref.train()
    inputs = {}
    hooks = [m.register_forward_pre_hook(lambda mod, a, key=k: inputs.__setitem__(key, a[0]))
             for k, m in ref.named_modules() if isinstance(m, BatchNorm)]
    stats = {k[:-len(".running_mean")]: (sd[k].double(), sd[k[:-4] + "var"].double())
             for k in sd if k.endswith("running_mean")}
    gen = torch.Generator().manual_seed(0)   # the state's generator after the fit's
    for _ in range(4):                        # 2 x 2 steps, one draw each (step_rng)
        torch.randint(0, 2**62, (), generator=gen)
    pipe = dm.pipeline
    for i, batch in enumerate(dm.train_batches(epoch=0, seed=0)):
        if i >= 2:
            break
        rng = np.random.default_rng(int(torch.randint(0, 2**62, (), generator=gen)))
        wave, labels = torch.as_tensor(batch["wave"]), torch.as_tensor(batch["label"])
        x, _ = pipe.train_batch(wave, labels, pipe.draw(len(labels), wave.shape[-1], rng))
        inputs.clear()
        with torch.no_grad():
            ref(x, dropout_seed=int(rng.integers(2**62)))
        for k, a in inputs.items():
            a = a.double().transpose(0, 1).reshape(a.shape[1], -1)
            mean, var = a.mean(1), a.var(1, unbiased=False)
            old_m, old_v = stats[k]
            stats[k] = (0.9 * old_m + 0.1 * mean, 0.9 * old_v + 0.1 * var)
    for h in hooks:
        h.remove()
    for k, (m, v) in stats.items():
        assert norm_err(got[k + ".running_mean"].numpy(), m.numpy()) < 1e-6, k
        assert norm_err(got[k + ".running_var"].numpy(), v.numpy()) < 1e-6, k
    assert not torch.equal(got["front.0.bn.running_mean"], sd["front.0.bn.running_mean"])
