"""Audio file IO + resampling (a copy of moshi_tpu/audio.py: the reference
uses `sphn`; wav via scipy, resampling via polyphase filtering)."""

import numpy as np


def read_wav(path, sample_rate: int | None = None) -> tuple[np.ndarray, int]:
    """Returns ([channels, T] float32 in [-1, 1], sample_rate)."""
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 1:
        data = data[None, :]
    else:
        data = data.T
    if sample_rate is not None and sr != sample_rate:
        data = resample(data, sr, sample_rate)
        sr = sample_rate
    return data, sr


def write_wav(path, pcm: np.ndarray, sample_rate: int):
    """pcm: [T] or [C, T] float32."""
    from scipy.io import wavfile
    pcm = np.asarray(pcm, np.float32)
    if pcm.ndim == 2:
        pcm = pcm.T
    wavfile.write(path, sample_rate, pcm)


def resample(pcm: np.ndarray, sr_from: int, sr_to: int) -> np.ndarray:
    from math import gcd
    from scipy.signal import resample_poly
    g = gcd(sr_from, sr_to)
    return resample_poly(pcm, sr_to // g, sr_from // g, axis=-1).astype(np.float32)
