"""Port parity: the log-mel front-end and kernel K1's module.

The same numpy-seeded waveforms go through ``dlsc_tpu.ops.mel`` (and the
Pallas kernel in interpret mode) and through ``dlsc_tpu_torch.ops.mel`` /
``ops.mel_kernel``. Tolerances:

- plain port vs plain JAX: both f32 rfft; normalised mel error < 1e-5, dB
  max-abs < 1e-3, AST features max-abs < 1e-4;
- port vs the Pallas kernel: the bars of tests/test_mel_pallas.py
  (normalised < 1e-4, dB < 1e-2, AST features < 1e-3);
- K1's arithmetic (``_mirror_mel_power``, a numpy mirror of the CUDA
  kernel's FFT, split and sparse bands over its own tables) vs the plain mel:
  normalised < 1e-5; vs the Pallas kernel: < 1e-4.
"""

import dataclasses

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


def _mirror_mel_power(wave: np.ndarray, cfg) -> np.ndarray:
    """K1's arithmetic in numpy (float64 over the kernel's f32 tables): the
    frames read through the reflect index, only on the window's support;
    the n_fft/2-point complex Stockham FFT of the sample pairs with the
    kernel's passes and their twiddle tables; the real-FFT split from the
    split twiddles; the power of bins 1..n_fft/2; the sparse bands summed in
    bin order."""
    c = MK.fft_mel_constants(cfg)
    nc, hop = cfg.n_fft // 2, cfg.hop_length
    B, T = wave.shape
    n_frames = cfg.num_frames(T)
    tw = c.twiddles[:, 0].astype(np.float64) + 1j * c.twiddles[:, 1]
    j = np.arange(n_frames)[:, None] * hop + np.arange(c.ws, c.we)[None, :] - nc
    j = np.where(j < 0, -j, np.where(j >= T, 2 * (T - 1) - j, j))
    xw = np.zeros((B, n_frames, cfg.n_fft))
    xw[:, :, c.ws:c.we] = wave[:, j].astype(np.float64) * c.window
    z = xw[..., 0::2] + 1j * xw[..., 1::2]
    ns, offsets = 1, {ns: off for _, ns, off in MK._pass_twiddles(nc)}
    for R in MK._fft_passes(nc):
        jj = np.arange(nc // R)
        k = jj % ns
        v = np.stack([z[..., jj + r * (nc // R)] for r in range(R)], -1)
        if ns > 1:   # the pass's own table: e^(-2πi k r / (ns R)) at (r - 1) ns + k
            v[..., 1:] *= tw[offsets[ns] + (np.arange(1, R)[None, :] - 1) * ns + k[:, None]]
        v = v @ np.exp(-2j * np.pi * np.outer(np.arange(R), np.arange(R)) / R)
        out = np.empty_like(z)
        for r in range(R):
            out[..., (jj // ns) * ns * R + k + r * ns] = v[..., r]
        z, ns = out, ns * R
    k = np.arange(1, nc)   # the split twiddles e^(-2πik/n_fft) lead the table
    a, b = z[..., k], np.conj(z[..., nc - k])
    x = (a + b) / 2 + tw[k] * (a - b) / 2j
    power = np.concatenate([np.abs(x) ** 2, (z[..., :1].real - z[..., :1].imag) ** 2], -1)
    mel = np.zeros((B, n_frames, cfg.n_mels))
    for m in range(cfg.n_mels):
        o0, o1 = c.band_off[m], c.band_off[m + 1]
        for o in range(o0, o1):   # bin order; power[..., i] is bin i + 1
            mel[..., m] += c.band_w[o] * power[..., c.band_first[m] + o - o0 - 1]
    return np.swapaxes(mel, 1, 2)


# n_fft 256 .. 2048 beside the two configs of CONFIGS
_FFT_CONFIGS = [M.MelConfig(n_fft=256, hop_length=80, win_length=200),
                M.MelConfig(n_fft=512, hop_length=160, win_length=400),
                M.MelConfig(n_fft=2048, hop_length=512, win_length=2048)]


@pytest.mark.parametrize("n", [44_100, 2_000])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kernel_constants_reproduce_plain_mel(name, n):
    """K1's arithmetic on the CPU (``_mirror_mel_power``: the reflect index,
    the window's support, the FFT and real-FFT split from the twiddle
    table, the sparse bands) gives the plain mel (normalised < 1e-5; f64
    here, so only the f32 tables differ), on a 1-s clip and on one shorter
    than a CTA's 32-frame tile."""
    cfg, _ = CONFIGS[name]
    c = MK.fft_mel_constants(cfg)
    win = M.hann_window_np(cfg.win_length, cfg.n_fft)
    assert not win[:c.ws].any() and not win[c.we:].any()   # only the window's zeros dropped
    assert MK._mel_plan(cfg, 2, n)["n_frames"] == cfg.num_frames(n)
    w = _wave(3, n)
    want = M.mel_spectrogram(torch.from_numpy(w), cfg).numpy()
    got = _mirror_mel_power(w, cfg)
    assert got.shape == want.shape
    assert norm_err(got, want) < 1e-5


@pytest.mark.parametrize("cfg", [c for c, _ in CONFIGS.values()] + _FFT_CONFIGS)
def test_sparse_bands_give_back_filterbank(cfg):
    """The bands (first bin, weights in bin order) are ``mel_filterbank_np``
    exactly: scattered back, bin by bin, they rebuild it bit for bit."""
    c = MK.fft_mel_constants(cfg)
    fb = np.zeros_like(M.mel_filterbank_np(cfg))
    for m in range(cfg.n_mels):
        o0, o1 = c.band_off[m], c.band_off[m + 1]
        fb[c.band_first[m]:c.band_first[m] + o1 - o0, m] = c.band_w[o0:o1]
    np.testing.assert_array_equal(fb, M.mel_filterbank_np(cfg))
    assert c.band_first.min() >= 1 and c.band_off[-1] == np.count_nonzero(fb)


@pytest.mark.parametrize("cfg", _FFT_CONFIGS)
def test_mirror_matches_plain_mel_at_other_ffts(cfg):
    """The mirror at n_fft 256, 512 and 2048 (2, 4 and 2 as the last radix)."""
    w = _wave(6, 3_000)
    assert norm_err(_mirror_mel_power(w, cfg),
                    M.mel_spectrogram(torch.from_numpy(w), cfg).numpy()) < 1e-5


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_mirror_matches_pallas_kernel(name):
    """The mirror against the TPU kernel in interpret mode at a short clip
    (normalised < 1e-4, the bar of tests/test_mel_pallas.py)."""
    cfg, jcfg = CONFIGS[name]
    w = _wave(7, 4_000)
    want = np.asarray(mel_power_pallas(jnp.asarray(w), jcfg, interpret=True))
    assert norm_err(_mirror_mel_power(w, cfg), want) < 1e-4


@pytest.mark.parametrize("cfg", [c for c, _ in CONFIGS.values()] + _FFT_CONFIGS)
def test_mel_plan(cfg):
    """The kernel's launch: 256 threads in n_fft/16-thread groups, one a
    frame in flight; passes whose radices multiply to n_fft/2; frame tiles
    whose staged span fits; shared memory within a block's 227 KB, and at
    the AST front-end small enough for 3 CTAs an SM (228 KB, 1 KB each
    reserved)."""
    plan = MK._mel_plan(cfg, 8, 220_500)
    assert plan["threads"] == plan["frames_in_flight"] * cfg.n_fft // 16 == 256
    assert np.prod(plan["passes"]) == cfg.n_fft // 2 and set(plan["passes"][:2]) == {8}
    c = MK.fft_mel_constants(cfg)
    ft = plan["frames_per_cta"]
    assert 1 <= ft <= 32 and (ft - 1) * cfg.hop_length + c.we - c.ws <= 16384
    assert plan["grid"] == (-(-cfg.num_frames(220_500) // ft), 8)
    assert plan["smem"] <= 232_448
    if cfg == M.MelConfig():
        assert 3 * (plan["smem"] + 1024) <= 228 * 1024


@pytest.mark.parametrize("changes", [dict(n_fft=1000), dict(n_fft=4096), dict(n_mels=64),
                                     dict(win_length=2048)])
def test_kernel_refuses_configs_it_does_not_take(changes):
    cfg = dataclasses.replace(M.MelConfig(), **changes)
    with pytest.raises(ValueError, match="n_fft"):
        MK.fft_mel_constants(cfg)
    with pytest.raises(ValueError, match="n_fft"):
        MK._mel_plan(cfg, 1, 44_100)


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
    """Every preprocessing mode of the JAX package is ported; an unknown one
    raises."""
    for mode in ("ast", "envnet_v2", "cnn_esc50", "raw"):
        assert DevicePipeline(PipelineConfig(mode=mode)).cfg.mode == mode
    with pytest.raises(ValueError, match="preprocessing_mode"):
        DevicePipeline(PipelineConfig(mode="mfcc"))

