"""The one generator of traffic: it reads a mix file (``traffic/<mix>.json``)
and makes, from ``--seed``, what the mix's driver feeds the port.

* ``requests``: the closed loop's requests, crops of a pool of seeded
  ``speech_like`` waveforms.  Their lengths are stratified: each block of
  ``block`` requests holds the same lengths, the quantiles
  ``(i + 1/2) / block`` of the log-uniform law over ``lengths_s``, in an
  order drawn from the seed, so every seed asks for the same work.
* ``write_corpus``: a corpus of seeded ``synth_speech`` WAV files under
  the process's temporary directory, with a ``train.csv`` index.
* ``segment_batches``: raw segments cropped from one seeded ``speech_like``
  waveform, for a feed made on the device.

Each part draws from its own stream of ``SeedSequence([seed, part])``.
"""

from __future__ import annotations

import concurrent.futures
import math
import os
import shutil
import tempfile
from typing import List, NamedTuple

import numpy as np

from perfbench.traffic import speech

POOL, REQUESTS, CORPUS, SEGMENTS = 1, 2, 3, 4


def _rng(seed: int, part: int, *more: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), part, *more])


class Request(NamedTuple):
    index: int
    pool: int
    offset: int
    length: int


def pool(mix: dict, seed: int) -> List[np.ndarray]:
    p = mix["pool"]
    rng = _rng(seed, POOL)
    return [speech.speech_like(rng, p["seconds"], mix["rate"]) for _ in range(p["count"])]


def stratified_lengths(mix: dict, rng: np.random.Generator, n: int) -> np.ndarray:
    """``n`` lengths in samples, block by block (module docstring)."""
    lo, hi = (math.log(s) for s in mix["lengths_s"])
    block = mix["block"]
    grid = np.exp(lo + (np.arange(block) + 0.5) / block * (hi - lo))
    grid = np.rint(grid * mix["rate"]).astype(np.int64)
    blocks = [grid[rng.permutation(block)] for _ in range(-(-n // block))]
    return np.concatenate(blocks)[:n]


def requests(mix: dict, seed: int, waves: List[np.ndarray]) -> List[Request]:
    rng = _rng(seed, REQUESTS)
    n = mix["requests"]
    lengths = stratified_lengths(mix, rng, n)
    which = rng.integers(0, len(waves), n)
    out = []
    for i, (length, w) in enumerate(zip(lengths, which)):
        room = len(waves[w]) - int(length)
        out.append(Request(i, int(w), int(rng.integers(0, room + 1)), int(length)))
    return out


def audio_of(req: Request, waves: List[np.ndarray]) -> np.ndarray:
    return waves[req.pool][req.offset:req.offset + req.length]


def corpus_dir(seed: int) -> str:
    """The corpus's directory: fixed for a seed, under ``TMPDIR``."""
    return os.path.join(tempfile.gettempdir(), "perfbench-corpus", str(int(seed)))


def write_corpus(mix: dict, seed: int, threads: int = 8) -> str:
    """The mix's ``corpus`` (``files`` WAVs of ``seconds`` at ``rate``),
    file ``i`` drawn from its own stream, written by ``threads`` threads;
    returns the path of its ``train.csv``."""
    c = mix["corpus"]
    out = corpus_dir(seed)
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)

    def one(i: int) -> str:
        name = f"{i:05d}.wav"
        speech.write_wav(os.path.join(out, name),
                         speech.synth_speech(_rng(seed, CORPUS, i), c["seconds"]), c["rate"])
        return name

    with concurrent.futures.ThreadPoolExecutor(threads) as pool_:
        names = list(pool_.map(one, range(c["files"])))
    index = os.path.join(out, "train.csv")
    with open(index, "w") as f:
        f.write("\n".join(names) + "\n")
    return index


def remove_corpus(seed: int) -> None:
    shutil.rmtree(corpus_dir(seed), ignore_errors=True)


def segment_batches(mix: dict, seed: int, batch: int, length: int) -> np.ndarray:
    """(``batches``, ``batch``, ``length``) float32 crops at ``rate`` of
    one ``speech_like`` waveform of ``source_seconds``."""
    rng = _rng(seed, SEGMENTS)
    src = speech.speech_like(rng, mix["source_seconds"], mix["rate"])
    n = mix["batches"] * batch
    starts = rng.integers(0, len(src) - length + 1, n)
    return np.stack([src[s:s + length] for s in starts]).reshape(
        mix["batches"], batch, length)
