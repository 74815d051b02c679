"""The rest of M1's mel API (``dlsc_tpu_torch/ops/mel.py``) against
``dlsc_tpu/ops/mel.py`` and the torchaudio-algorithm oracle
``tests/reference_dsp.py``, on the CPU.

- The mel scales (``_hz_to_mel`` / ``_mel_to_hz``, HTK and Slaney) and the
  filterbanks (HTK and Slaney scale, with and without Slaney's area norm):
  bit-equal to the JAX package's numpy functions (the same float64 numpy
  arithmetic, cast to f32 at the end).
- ``_dct_matrix_np``: bit-equal to JAX's; 1e-5 of the largest entry of
  ``reference_dsp.create_dct``, which builds the basis in f32 torch (cos
  arguments up to 37 rad rounded to f32: 3.3e-6 measured).
- ``mfcc`` (ortho and unnormalised DCT, dB and log mels) against the JAX
  ``mfcc``: 1e-4 of the largest coefficient (the f32 FFTs of the two
  packages differ in summation order only); the ortho dB form against
  ``reference_dsp.mfcc_torch``: 1e-4 likewise.
- A power-1 spectrogram and ``amplitude_to_db(stype='amplitude')`` against
  JAX and the reference: the mel magnitude 1e-5 of its largest entry, the
  dB 1e-3 absolute (a dB step of 1e-3 is a 1.2e-4 relative change).
- Kernel K1 takes only power 2: any other power is refused before a launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dlsc_tpu.ops import mel as JM
from dlsc_tpu_torch.ops import mel as M
from dlsc_tpu_torch.ops import mel_kernel as MK
from tests import reference_dsp as R

SR = 16_000


def _wave(batch=2, n=SR // 2, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    w = 0.3 * np.sin(2 * np.pi * 440 * t) + 0.05 * rng.standard_normal((batch, n))
    return w.astype(np.float32)


def _cfgs(**kw):
    base = dict(sample_rate=SR, n_fft=512, hop_length=160, win_length=400, n_mels=40)
    base.update(kw)
    return M.MelConfig(**base), JM.MelConfig(**base)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("scale", ["htk", "slaney"])
def test_mel_scales_match_jax(scale):
    f = np.asarray([0.0, 50.0, 700.0, 999.0, 1000.0, 1001.0, 4000.0, 22050.0])
    np.testing.assert_array_equal(M._hz_to_mel(f, scale), JM._hz_to_mel(f, scale))
    m = M._hz_to_mel(f, scale)
    np.testing.assert_array_equal(M._mel_to_hz(m, scale), JM._mel_to_hz(m, scale))
    np.testing.assert_allclose(M._mel_to_hz(m, scale), f, rtol=1e-12, atol=1e-9)


@pytest.mark.parametrize("scale,norm", [("slaney", None), ("slaney", "slaney"),
                                        ("htk", "slaney"), ("htk", None)])
def test_filterbanks_match_jax(scale, norm):
    cfg, jcfg = _cfgs(mel_scale=scale, mel_norm=norm, f_min=20.0, f_max=7600.0)
    got = M.mel_filterbank_np(cfg)
    want = np.asarray(JM.mel_filterbank(jcfg))
    np.testing.assert_array_equal(got, want)
    if norm is None and scale == "htk":
        np.testing.assert_array_equal(
            got, R.melscale_fbanks(cfg.n_freqs, 20.0, 7600.0, cfg.n_mels, SR).numpy())


@pytest.mark.parametrize("norm", ["ortho", None])
def test_dct_matrix(norm):
    got = M._dct_matrix_np(13, 40, norm)
    np.testing.assert_array_equal(got, JM._dct_matrix_np(13, 40, norm))
    want = R.create_dct(13, 40, norm).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("norm,log_mels,scale", [("ortho", False, "htk"),
                                                 (None, False, "slaney"),
                                                 ("ortho", True, "htk")])
def test_mfcc_matches_jax(norm, log_mels, scale):
    cfg, jcfg = _cfgs(mel_scale=scale, mel_norm="slaney" if scale == "slaney" else None)
    wave = _wave()
    got = M.mfcc(torch.from_numpy(wave), cfg, n_mfcc=20, norm=norm, log_mels=log_mels)
    want = JM.mfcc(jnp.asarray(wave), jcfg, n_mfcc=20, norm=norm, log_mels=log_mels)
    assert got.shape == (2, 20, cfg.num_frames(wave.shape[-1]))
    assert _rel(got.numpy(), want) <= 1e-4


def test_mfcc_matches_the_reference():
    cfg, _ = _cfgs()
    wave = _wave(batch=1)
    got = M.mfcc(torch.from_numpy(wave), cfg, n_mfcc=40)[0]
    want = R.mfcc_torch(torch.from_numpy(wave[0]), SR, 512, 160, 400, 40, 40)
    assert _rel(got.numpy(), want.numpy()) <= 1e-4


def test_amplitude_db_matches_jax_and_the_reference():
    cfg, jcfg = _cfgs(power=1.0)
    wave = _wave(batch=1)
    mel = M.mel_spectrogram(torch.from_numpy(wave), cfg)
    jmel = np.asarray(JM.mel_spectrogram(jnp.asarray(wave), jcfg))
    ref = R.mel_spectrogram_torch(torch.from_numpy(wave[0]), SR, 512, 160, 400, 40,
                                  power=1.0).numpy()
    assert _rel(mel.numpy(), jmel) <= 1e-5 and _rel(mel[0].numpy(), ref) <= 1e-5
    for top_db in (80.0, None):
        db = M.amplitude_to_db(mel, top_db=top_db, stype="amplitude").numpy()
        jdb = np.asarray(JM.amplitude_to_db(jnp.asarray(jmel), stype="amplitude",
                                            top_db=top_db))
        rdb = R.amplitude_to_db_torch(torch.from_numpy(ref), top_db=top_db,
                                      stype="amplitude").numpy()
        np.testing.assert_allclose(db, jdb, atol=1e-3)
        np.testing.assert_allclose(db[0], rdb, atol=1e-3)
    # 'amplitude' is twice the 'power' dB of the same values
    np.testing.assert_allclose(M.amplitude_to_db(mel, None, "amplitude").numpy(),
                               2 * M.amplitude_to_db(mel, None).numpy(), rtol=1e-6)


def test_kernel_takes_only_power_two():
    MK._check_config(M.MelConfig())
    with pytest.raises(ValueError, match="power 2"):
        MK._check_config(M.MelConfig(power=1.0))
