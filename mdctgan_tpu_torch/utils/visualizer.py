"""Training logs and visuals: a copy of ``mdctgan_tpu/utils/visualizer.py``
(the reference's ``util/visualizer.py``).

Sinks, as in the reference:
  * the console and ``loss_log.txt``, line for line the JAX package's;
  * TensorBoard scalars and images with ``--tf_log``, through
    ``torch.utils.tensorboard`` where it imports (absent otherwise, as in
    the JAX package);
  * the self-refreshing HTML gallery under ``web/`` (needs matplotlib).

Under data parallelism only the main rank (``is_main``) writes the file
sinks; every rank prints its lines to the console, as in the JAX package.
"""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np

from mdctgan_tpu_torch.utils import html as html_mod
from mdctgan_tpu_torch.utils.spectro_img import compute_visuals


class Visualizer:
    def __init__(self, opt, is_main: bool = True):
        self.is_main = is_main
        self.tf_log = bool(getattr(opt, "tf_log", False)) and is_main
        self.use_html = (bool(getattr(opt, "isTrain", True))
                         and not getattr(opt, "no_html", False) and is_main)
        self.win_size = getattr(opt, "display_winsize", 512)
        self.abs_spectro = bool(getattr(opt, "abs_spectro", False))
        self.name = opt.name
        self.save_dir = os.path.join(opt.checkpoints_dir, opt.name)
        self._writer = None
        if self.tf_log:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._writer = SummaryWriter(log_dir=os.path.join(self.save_dir, "logs"))
            except ImportError:
                self._writer = None
        if self.use_html:
            self.web_dir = os.path.join(self.save_dir, "web")
            self.img_dir = os.path.join(self.web_dir, "images")
            os.makedirs(self.img_dir, exist_ok=True)
        self.log_name = os.path.join(self.save_dir, "loss_log.txt")
        if is_main:
            with open(self.log_name, "a") as f:
                f.write(f"================ Training Loss ({time.strftime('%c')}) "
                        "================\n")

    def print_current_errors(self, epoch: int, i: int, errors: Dict[str, float],
                             t: float) -> None:
        """One line to the console and to ``loss_log.txt``; a loss that is
        0 (inactive) is left out, as the reference does."""
        message = f"(epoch: {epoch}, iters: {i}, time: {t:.3f}) "
        for k, v in errors.items():
            if float(v) != 0:
                message += f"{k}: {float(v):.3f} "
        print(message)
        if self.is_main:
            with open(self.log_name, "a") as f:
                f.write(f"{message}\n")

    def plot_current_errors(self, errors: Dict[str, float], step: int) -> None:
        if self._writer is not None:
            self._writer.add_scalars("Losses", {k: float(v) for k, v in errors.items()}, step)

    def display_current_results(self, visuals: Dict[str, np.ndarray], epoch: int,
                                step: int) -> None:
        """Render ``visuals`` (label -> (F, K) spectrogram, or None) to
        TensorBoard images and the HTML gallery."""
        if self._writer is None and not self.use_html:
            return  # no sink: skip the renders
        images = {}
        for label, spec in visuals.items():
            if spec is None:
                continue
            img, hist = compute_visuals(np.asarray(spec), abs_spectro=self.abs_spectro)
            if img is not None:
                images[label] = img
                images[f"{label}_hist"] = hist
        if self._writer is not None:
            for label, img in images.items():
                self._writer.add_image(label, img, step, dataformats="HWC")
        if self.use_html and images:
            import matplotlib.image as mpimg

            for label, img in images.items():
                mpimg.imsave(os.path.join(self.img_dir, f"epoch{epoch:03d}_{label}.jpg"), img)
            page = html_mod.HTML(self.web_dir, f"Experiment = {self.name}", refresh=30)
            for n in range(epoch, 0, -1):
                names = sorted(f for f in os.listdir(self.img_dir)
                               if f.startswith(f"epoch{n:03d}_"))
                if not names:
                    continue
                page.add_header(f"epoch [{n}]")
                page.add_images(names, [f[len(f"epoch{n:03d}_"):] for f in names],
                                width=self.win_size)
            page.save()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
