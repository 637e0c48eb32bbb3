"""Feature extraction: audio -> log-mel, on the device (torch) and on the
host (native C++), and the frame-level steps after it.

A port of `gasr_tpu/data/features.py`. Two log-mel paths with the same
conventions (center=False framing, periodic Hann window, power spectrum,
HTK-mel triangular filterbank with integer-bin vertices, log(mel + 1e-10)):

  - `logmel_torch` (JAX's `logmel_jax`): framing, window, `torch.fft.rfft`,
    power, mel product and log on the device of its input (cuFFT on the
    card);
  - `gasr_tpu_torch.native.logmel`: the C++ host front end that
    `Pipeline.transcribe_audio` runs per utterance, as JAX's does.

`cmvn` is per-utterance mean/variance normalization over time (with
`lengths`, over the valid frames only, and padded frames zeroed);
`add_context` is the reference's n_context frame stacking
(baseline/model.py:23, input_size*(1+2*n_context)), edge-padded.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _mel_filterbank(sample_rate: int, n_fft: int, n_mels: int,
                    fmin: float, fmax: float) -> np.ndarray:
    """Triangular mel filterbank [n_mels, n_fft//2+1], HTK mel scale,
    integer-bin vertices (matches gasr_native.cpp gasr_logmel)."""
    def hz2mel(h):
        return 2595.0 * np.log10(1.0 + h / 700.0)

    def mel2hz(m):
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)

    if fmax <= 0:
        fmax = sample_rate / 2.0
    pts = mel2hz(np.linspace(hz2mel(fmin), hz2mel(fmax), n_mels + 2))
    bins = np.floor((n_fft + 1) * pts / sample_rate).astype(int)
    fb = np.zeros((n_mels, n_fft // 2 + 1), np.float32)
    for m in range(n_mels):
        lo, c, hi = bins[m], bins[m + 1], bins[m + 2]
        for b in range(lo, c):
            if c > lo:
                fb[m, b] = (b - lo) / (c - lo)
        for b in range(c, min(hi, n_fft // 2 + 1)):
            if hi > c:
                fb[m, b] = (hi - b) / (hi - c)
    return fb


def logmel_torch(audio: torch.Tensor, sample_rate: int = 16000,
                 n_fft: int = 512, hop: int = 160, n_mels: int = 80,
                 fmin: float = 0.0, fmax: float = 0.0) -> torch.Tensor:
    """audio [..., n] float32 -> log-mel [..., n_frames, n_mels]
    (center=False), on audio's device."""
    audio = audio.to(torch.float32)
    frames = audio.unfold(-1, n_fft, hop)                 # [..., F, n_fft]
    window = 0.5 - 0.5 * torch.cos(
        2.0 * math.pi * torch.arange(n_fft, dtype=torch.float32,
                                     device=audio.device) / n_fft)
    spec = torch.fft.rfft(frames * window, n=n_fft)
    power = spec.abs() ** 2
    fb = torch.from_numpy(_mel_filterbank(sample_rate, n_fft, n_mels, fmin,
                                          fmax)).to(audio.device)
    mel = torch.einsum("...fb,mb->...fm", power, fb)
    return torch.log(mel + 1e-10)


def cmvn(feats: torch.Tensor, lengths=None, eps: float = 1e-8
         ) -> torch.Tensor:
    """Per-utterance mean/variance normalization over time.

    feats [..., T, F] -> zero mean, unit variance per (utterance,
    feature). With `lengths` [...] (tensor or array), padded frames
    (t >= length) are left out of the statistics and zeroed."""
    if lengths is None:
        m = feats.mean(dim=-2, keepdim=True)
        v = feats.var(dim=-2, keepdim=True, correction=0)
        return (feats - m) / torch.sqrt(v + eps)
    T = feats.shape[-2]
    lengths = torch.as_tensor(lengths, device=feats.device)
    mask = (torch.arange(T, device=feats.device)[:, None]
            < lengths[..., None, None]).to(feats.dtype)
    n = torch.clamp_min(mask.sum(dim=-2, keepdim=True), 1.0)
    m = (feats * mask).sum(dim=-2, keepdim=True) / n
    v = ((feats - m) ** 2 * mask).sum(dim=-2, keepdim=True) / n
    return (feats - m) / torch.sqrt(v + eps) * mask


def add_context(feats: torch.Tensor, n_context: int) -> torch.Tensor:
    """Frame stacking: [.., T, F] -> [.., T, F*(1+2*n_context)]; each
    frame is concatenated with n_context frames on each side, the edge
    frames repeated past either end."""
    if n_context == 0:
        return feats
    T = feats.shape[-2]
    t = torch.arange(T, device=feats.device)
    parts = [feats.index_select(-2, (t + i - n_context).clamp(0, T - 1))
             for i in range(2 * n_context + 1)]
    return torch.cat(parts, dim=-1)
