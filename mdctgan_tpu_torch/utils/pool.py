"""Fake-sample replay pool: a copy of ``mdctgan_tpu/utils/pool.py``, which
holds no JAX but belongs to the reference package.

The reference's pool swaps samples inside the forward pass.  Here it is two
host-side halves around the train step:

  * ``presample(shape)``: before the step, draw the swap decisions and the
    old samples (they depend only on the pool and its generator, never on
    the new fakes); returns ``(old_batch, use_old_mask)`` as numpy arrays
    that the step mixes per sample.
  * ``commit(fakes)``: after the step, append or replace with the new fakes.

``numpy.random.default_rng(seed)`` draws the decisions, as in the JAX
package, so both pools decide alike under one seed.  With ``pool_size == 0``
(the shipped default) the pool is inert and the step uses the current fakes.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


class ImagePool:
    def __init__(self, pool_size: int, seed: int = 0):
        self.pool_size = int(pool_size)
        self.images: List[np.ndarray] = []
        self._rng = np.random.default_rng(seed)
        self._pending: Optional[np.ndarray] = None

    @property
    def enabled(self) -> bool:
        return self.pool_size > 0

    def presample(self, shape: Tuple[int, ...]) -> Tuple[np.ndarray, np.ndarray]:
        """(old_batch[B,...], use_old_mask[B]) for a batch of ``shape``.

        Per sample: while the pool is not full the new sample is stored and
        used (mask 0); once full, with p > 0.5 a random stored sample is
        returned and later replaced by the new one.
        """
        b = shape[0]
        old = np.zeros(shape, np.float32)
        mask = np.zeros((b,), bool)
        slots = np.full((b,), -1, np.int64)
        for i in range(b):
            if len(self.images) + int((slots[:i] == -2).sum()) < self.pool_size:
                slots[i] = -2  # append slot
            elif (
                self.enabled
                # full with stored samples, not only with this batch's
                # pending appends, which presample cannot swap against
                and len(self.images) == self.pool_size
                and self._rng.uniform() > 0.5
            ):
                j = int(self._rng.integers(0, self.pool_size))
                old[i] = self.images[j]
                mask[i] = True
                slots[i] = j  # replace slot
        self._pending = slots
        return old, mask

    def commit(self, fakes: np.ndarray, keep: Optional[np.ndarray] = None) -> None:
        """Apply the pool changes that the last ``presample`` decided.
        ``fakes`` may hold fewer rows than were decided for: a padded tail
        batch commits its real rows only; ``keep`` (bool, one per row of
        ``fakes``) names the rows to commit where they are not the first
        ones (a data-parallel tail, padded on every host)."""
        if not self.enabled or self._pending is None:
            return
        slots = self._pending
        self._pending = None
        for i, s in enumerate(slots[: len(fakes)]):
            if keep is not None and not keep[i]:
                continue
            if s == -2:
                self.images.append(np.asarray(fakes[i]))
            elif s >= 0:
                self.images[int(s)] = np.asarray(fakes[i])
