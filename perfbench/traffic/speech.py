"""Seeded audio for the traffic: frozen copies of the port's
``data/synthetic.py`` ``speech_like`` and of ``tools/make_corpus.py``'s
``--style speech`` synthesiser (``synth_speech``) and WAV writer.

``synth_speech``: sentence-structured utterances of words of 1-4
syllables, each an optional fricative or plosive onset and a
formant-synthesised vowel, with F0 declination and jitter, syllabic
envelopes and pauses, at 48 kHz; the fricatives put energy in the 4-20 kHz
band that a 16 kHz recording cannot carry.
"""

from __future__ import annotations

import struct

import numpy as np

SR = 48000


def speech_like(rng: np.random.Generator, seconds: float, rate: int = 16000) -> np.ndarray:
    """Harmonic-plus-noise signal: 11 harmonics of a fundamental gliding
    around 140 Hz, amplitude 0.2/k, plus noise of sigma 0.003."""
    n = int(round(seconds * rate))
    t = np.arange(n) / rate
    f0 = 140.0 + 40.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    x = sum(0.2 / k * np.sin(k * phase) for k in range(1, 12))
    return (x + 0.003 * rng.standard_normal(n)).astype(np.float32)


# (F1, F2, F3) presets, Hz — Peterson–Barney-ish vowel targets
_VOWELS = [
    (730, 1090, 2440),   # /a/
    (270, 2290, 3010),   # /i/
    (300, 870, 2240),    # /u/
    (530, 1840, 2480),   # /e/
    (570, 840, 2410),    # /o/
    (660, 1720, 2410),   # /ae/
    (490, 1350, 1690),   # /er/
]
_BWS = (90.0, 110.0, 170.0, 250.0)  # resonance bandwidths F1..F4


def _resonance(f: np.ndarray, fc: float, bw: float) -> np.ndarray:
    """Magnitude of a 2nd-order resonator, peak-normalized to 1 at fc."""
    num = fc * bw
    return num / np.sqrt((f ** 2 - fc ** 2) ** 2 + (f * bw) ** 2 + 1e-12)


def _formant_env(f: np.ndarray, formants, gains=None) -> np.ndarray:
    env = np.zeros_like(f)
    for i, fc in enumerate(formants):
        g = 1.0 if gains is None else gains[i]
        env += g * _resonance(f, fc, _BWS[min(i, len(_BWS) - 1)])
    # glottal-source tilt: ~-6 dB/oct above 500 Hz
    env *= 1.0 / np.sqrt(1.0 + (f / 500.0) ** 2)
    return env


def _shaped_noise(rng, n: int, shape_fn) -> np.ndarray:
    """White noise spectrally shaped by |H(f)| = shape_fn(f) via one rFFT."""
    spec = np.fft.rfft(rng.standard_normal(n))
    f = np.fft.rfftfreq(n, 1.0 / SR)
    x = np.fft.irfft(spec * shape_fn(f), n)
    return x / max(1e-9, np.sqrt(np.mean(x ** 2)))


def _edge_ramp(x: np.ndarray, ms: float = 5.0) -> np.ndarray:
    r = min(len(x) // 2, int(SR * ms / 1000))
    if r > 0:
        w = 0.5 - 0.5 * np.cos(np.pi * np.arange(r) / r)
        x[:r] *= w
        x[-r:] *= w[::-1]
    return x


def _vowel(rng, dur_s: float, f0_start: float, f0_end: float) -> np.ndarray:
    n = max(1, int(dur_s * SR))
    t = np.arange(n) / SR
    # F0 contour: glide + 5 Hz vibrato + jitter
    f0_t = (f0_start + (f0_end - f0_start) * t / dur_s)
    f0_t = f0_t * (1.0 + 0.01 * np.sin(2 * np.pi * 5.0 * t)
                   + 0.003 * rng.standard_normal(n))
    phase = 2 * np.pi * np.cumsum(f0_t) / SR

    v = _VOWELS[rng.integers(len(_VOWELS))]
    # per-utterance formant scatter + an F4 above F3
    formants = [fc * rng.uniform(0.92, 1.08) for fc in v]
    formants.append(formants[-1] + rng.uniform(600, 1100))

    f0m = float(np.mean(f0_t))
    k = np.arange(1, int(SR / 2 / f0m))
    amps = _formant_env(k * f0m, formants)
    amps /= max(1e-9, amps.max())
    # additive partials (K, n) — cheap and exactly formant-shaped
    x = (amps[:, None] * np.sin(np.outer(k, phase))).sum(axis=0)
    # aspiration: formant-shaped noise ~22 dB under the voiced part
    x += 0.08 * _shaped_noise(
        rng, n, lambda f: _formant_env(f, formants)) * np.sqrt(np.mean(x ** 2))
    return _edge_ramp(x / max(1e-9, np.abs(x).max()), ms=8.0)


def _fricative(rng, dur_s: float) -> np.ndarray:
    """/s,sh,f/-like: noise with a high-frequency hump — the 4-20 kHz energy
    a 16 kHz LR recording cannot carry, i.e. what BWE must reconstruct."""
    n = max(1, int(dur_s * SR))
    fc = rng.uniform(3500, 10000)
    bw = rng.uniform(2000, 6000)

    def shape(f):
        hump = np.exp(-0.5 * ((f - fc) / bw) ** 2)
        return hump + 0.05  # broadband floor

    x = _shaped_noise(rng, n, shape)
    return _edge_ramp(0.35 * x / max(1e-9, np.abs(x).max()), ms=10.0)


def _plosive(rng) -> np.ndarray:
    """Closure silence + a short decaying burst."""
    closure = np.zeros(int(SR * rng.uniform(0.015, 0.045)))
    nb = int(SR * rng.uniform(0.006, 0.02))
    fc = rng.uniform(1500, 6000)
    burst = _shaped_noise(
        rng, nb, lambda f: np.exp(-0.5 * ((f - fc) / 2500.0) ** 2) + 0.1)
    burst *= np.exp(-np.arange(nb) / (0.25 * nb + 1))
    return np.concatenate([closure, 0.5 * burst / max(1e-9, np.abs(burst).max())])


def synth_speech(rng: np.random.Generator, seconds: float) -> np.ndarray:
    n_total = int(seconds * SR)
    pieces = []
    n_acc = 0
    f0_base = rng.uniform(95, 230)  # speaker pitch
    f0_now = f0_base * rng.uniform(1.1, 1.3)  # sentence declination start
    while n_acc < n_total:
        # one word: 1-4 syllables
        for _ in range(rng.integers(1, 5)):
            r = rng.random()
            if r < 0.35:
                pieces.append(_fricative(rng, rng.uniform(0.06, 0.18)))
            elif r < 0.6:
                pieces.append(_plosive(rng))
            f0_next = max(70.0, f0_now * rng.uniform(0.9, 1.02))
            vow = _vowel(rng, rng.uniform(0.08, 0.28), f0_now, f0_next)
            # syllabic loudness envelope
            tv = np.linspace(0, 1, len(vow))
            vow = vow * (0.6 + 0.4 * np.sin(np.pi * tv) ** 0.7)
            pieces.append(vow)
            f0_now = f0_next
            # occasional coda fricative
            if rng.random() < 0.2:
                pieces.append(_fricative(rng, rng.uniform(0.05, 0.12)))
        pieces.append(np.zeros(int(SR * rng.uniform(0.05, 0.25))))  # pause
        n_acc = sum(len(p) for p in pieces)
        if f0_now < 0.75 * f0_base:  # new breath group
            f0_now = f0_base * rng.uniform(1.05, 1.25)
    x = np.concatenate(pieces)[:n_total]
    x += 0.0015 * rng.standard_normal(n_total)  # room/recording floor
    x *= 0.25 / max(1e-9, np.abs(x).max())
    return x.astype(np.float32)


def write_wav(path: str, x: np.ndarray, sr: int = SR) -> None:
    pcm = (np.clip(x, -1, 1) * 32767).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)
