"""Port parity: the log-mel front-end and kernel K1's module.

The same numpy-seeded waveforms go through ``dlsc_tpu.ops.mel`` (and the
Pallas kernel in interpret mode) and through ``dlsc_tpu_torch.ops.mel`` /
``ops.mel_kernel``. Tolerances:

- plain port vs plain JAX: both f32 rfft; normalised mel error < 1e-5, dB
  max-abs < 1e-3, AST features max-abs < 1e-4;
- port vs the Pallas kernel: the bars of tests/test_mel_pallas.py
  (normalised < 1e-4, dB < 1e-2, AST features < 1e-3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.data.pipeline import DevicePipeline as JaxPipeline
from dlsc_tpu.data.pipeline import PipelineConfig as JaxPipelineConfig
from dlsc_tpu.ops import mel as JM
from dlsc_tpu.ops.mel_pallas import mel_power_pallas
from dlsc_tpu_torch.data.pipeline import DevicePipeline, PipelineConfig
from dlsc_tpu_torch.ops import mel as M
from dlsc_tpu_torch.ops import mel_kernel as MK

CONFIGS = {
    "ast": (M.MelConfig(), JM.MelConfig()),
    "cnn": (M.MelConfig(n_fft=1024, hop_length=512, win_length=1024),
            JM.MelConfig(n_fft=1024, hop_length=512, win_length=1024)),
}


def norm_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12)


def _wave(seed, n=44_100, b=2):
    return (np.random.default_rng(seed).standard_normal((b, n)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_window_and_filterbank_equal_jax_numpy(name):
    cfg, jcfg = CONFIGS[name]
    np.testing.assert_array_equal(M.hann_window_np(cfg.win_length, cfg.n_fft),
                                  JM.hann_window_np(jcfg.win_length, jcfg.n_fft))
    np.testing.assert_array_equal(M.mel_filterbank_np(cfg),
                                  np.asarray(JM.mel_filterbank(jcfg)))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_mel_matches_jax(name):
    cfg, jcfg = CONFIGS[name]
    w = _wave(1)
    got = M.mel_spectrogram(torch.from_numpy(w), cfg).numpy()
    want = np.asarray(JM.mel_spectrogram(jnp.asarray(w), jcfg))
    assert got.shape == want.shape
    assert norm_err(got, want) < 1e-5
    got_db = M.amplitude_to_db(torch.from_numpy(got), cfg.top_db)
    want_db = JM.amplitude_to_db(jnp.asarray(want), top_db=jcfg.top_db)
    assert np.abs(got_db.numpy() - np.asarray(want_db)).max() < 1e-3
    got_ast = M.ast_normalize(M.log_mel_spectrogram(torch.from_numpy(w), cfg)).numpy()
    want_ast = np.asarray(JM.ast_normalize(JM.log_mel_spectrogram(jnp.asarray(w), jcfg)))
    assert np.abs(got_ast - want_ast).max() < 1e-4


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_plain_mel_matches_pallas_kernel(name):
    cfg, jcfg = CONFIGS[name]
    w = _wave(2)
    got = M.mel_spectrogram(torch.from_numpy(w), cfg)
    want = np.asarray(mel_power_pallas(jnp.asarray(w), jcfg, interpret=True))
    assert norm_err(got.numpy(), want) < 1e-4
    got_db = M.amplitude_to_db(got, cfg.top_db)
    want_db = np.asarray(JM.amplitude_to_db(jnp.asarray(want), top_db=jcfg.top_db))
    assert np.abs(got_db.numpy() - want_db).max() < 1e-2
    got_ast = M.ast_normalize(got_db).numpy()
    assert np.abs(got_ast - np.asarray(JM.ast_normalize(jnp.asarray(want_db)))).max() < 1e-3


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_constants_reproduce_plain_mel(name):
    """K1's arithmetic on the CPU: the trimmed windowed-DFT rows, the DC-less
    filterbank and the framing ``chunk[i * hop + lo + n]`` give the plain mel
    (normalised < 1e-5; f64 here, so only the f32 constants differ)."""
    cfg, _ = CONFIGS[name]
    lo, cos_w, sin_w, fb = MK.dft_mel_constants(cfg)
    L = cos_w.shape[0]
    win = M.hann_window_np(cfg.win_length, cfg.n_fft)
    assert L % 32 == 0 and lo % 32 == 0
    assert not win[:lo].any() and not win[lo + L:].any()  # only zero rows dropped
    w = _wave(3)
    pad = cfg.n_fft // 2
    padded = np.pad(w.astype(np.float64), ((0, 0), (pad, pad)), mode="reflect")
    n_frames = cfg.num_frames(w.shape[1])
    idx = np.arange(n_frames)[:, None] * cfg.hop_length + lo + np.arange(L)[None, :]
    frames = padded[:, idx]                                   # (B, n_frames, L)
    power = (frames @ cos_w.astype(np.float64)) ** 2 + (frames @ sin_w.astype(np.float64)) ** 2
    got = np.swapaxes(power @ fb.astype(np.float64), 1, 2)
    want = M.mel_spectrogram(torch.from_numpy(w), cfg).numpy()
    assert norm_err(got, want) < 1e-5


def test_cpu_tensor_takes_plain_path():
    """On a CPU tensor the wrappers run the plain version and launch nothing."""
    MK.reset_launches()
    w = torch.from_numpy(_wave(4))
    cfg = M.MelConfig()
    assert torch.equal(MK.mel_power(w, cfg), M.mel_spectrogram(w, cfg))
    assert torch.equal(MK.ast_features(w, cfg),
                       M.ast_normalize(M.log_mel_spectrogram(w, cfg)))
    assert MK.launches == 0


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_eval_pipeline_matches_jax(dtype):
    """AST eval pipeline (PCM16 or float in → features), port vs JAX."""
    w = _wave(5)
    if dtype == "int16":
        w = (w * 20000).astype(np.int16)
    got = DevicePipeline(PipelineConfig(mode="ast")).eval_batch(torch.from_numpy(w))
    want, _ = JaxPipeline(JaxPipelineConfig(mode="ast")).eval_batch(
        jnp.asarray(w), jnp.zeros((2,), jnp.int32))
    assert got.shape == want.shape
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-4


def test_unported_mode_raises():
    with pytest.raises(NotImplementedError, match="M7"):
        DevicePipeline(PipelineConfig(mode="envnet_v2"))

