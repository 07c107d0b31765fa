"""CLI options, the spectral configuration and the train options.

``BaseOptions``/``TrainOptions``/``TestOptions`` are a copy of the JAX
package's ``options.py``: the same flags, defaults and ``opt.txt``.  What
the port reads differently:

* ``--gpu_ids``: ``-1`` is the explicit request for the CPU; ids ``a,b,..``
  mean ``cuda:a``, ``cuda:b``, .. and raise without CUDA or where this host
  has no such card (the JAX CLIs clamp the count silently): one replica a
  card in the generate CLI, one rank a card in the train CLI
  (``parallel/mesh.py``).  ``serving_devices`` resolves it.
* ``--multihost``: the train CLI joins the process group that torchrun's
  variables describe, on ``cuda:<LOCAL_RANK>`` (``--gpu_ids -1``: the CPU);
  ``--batchSize`` is then each host's batch.
* ``--fused_mdct``: ``auto`` launches K1/K2 on a CUDA tensor for the
  configurations they serve and runs the matmul form for the others
  (``ops/features.py``); ``on`` raises ``ValueError`` for a configuration
  K1/K2 do not serve, as the JAX package does (and, unlike it, for an
  n_fft above the dense kernels' ``dense_max_n`` on the cards ``--gpu_ids``
  names, or sm_90's 5568 where this host has none of them; ``auto`` gives
  such an n_fft the matmul form); ``off`` raises, because the
  plain versions are the CPU path and the spec, not a serving path.
* ``--upsample_method``, ``--head_phases``, ``--dilated_vjp``,
  ``--matmul_precision`` and ``--jax_cache_dir`` select equal-math TPU forms
  in JAX; they are parsed, recorded in ``opt.txt`` and ignored.  The port
  sets no environment variable.

The port's functions also take their options as a plain dict whose keys are
these flags (``configs.flagship_opt()``); ``as_dict`` reads either form.  A
spectral key that is absent takes the ``SpectralConfig`` default, which is
the flagship transform; a train key that is absent takes the default of the
train options.
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Mapping

import torch

from mdctgan_tpu_torch.device import resolve_device
from mdctgan_tpu_torch.ops.features import SpectralConfig, fused_compatible
from mdctgan_tpu_torch.ops.mdct_kernels import dense_max_n

# the reference's audio_config.py constants
N_FFT = 512
HOP_LENGTH = 256
WIN_LENGTH = 512
LR_SAMPLE_RATE = 8000
HR_SAMPLE_RATE = 48000
SR_SAMPLE_RATE = 48000
BINS = 128
CENTER = True
FRAME_LENGTH = (BINS - 1) * HOP_LENGTH if CENTER else (BINS - 1) * HOP_LENGTH + WIN_LENGTH


def _param_key_map(x: str) -> Dict[str, str]:
    """``"a:b,c:d"`` -> ``{"a": "b", "c": "d"}``."""
    return {str(k): str(v) for k, v in (i.split(":") for i in x.split(","))}


class BaseOptions:
    def __init__(self):
        self.parser = argparse.ArgumentParser()
        self.initialized = False
        self.isTrain = True

    def initialize(self):
        p = self.parser
        # experiment specifics
        p.add_argument("--name", type=str, default="label2city")
        p.add_argument("--gpu_ids", type=str, default="0",
                       help="the CUDA device id; -1 for the CPU")
        p.add_argument("--checkpoints_dir", type=str, default="./checkpoints")
        p.add_argument("--model", type=str, default="pix2pixHD")
        p.add_argument("--norm", type=str, default="instance")
        p.add_argument("--use_dropout", action="store_true")
        p.add_argument("--data_type", default=32, type=int, choices=[8, 16, 32])
        p.add_argument("--verbose", action="store_true", default=False)
        p.add_argument("--fp16", action="store_true", default=False,
                       help="bf16 compute policy: G and D compute in bf16 on "
                            "float32 parameters")
        p.add_argument("--fused_mdct", type=str, default="auto",
                       choices=["auto", "on", "off"],
                       help="auto/on: the CUDA MDCT kernels on the card; off "
                            "raises")
        p.add_argument("--upsample_method", type=str, default="auto",
                       choices=["auto", "dilated", "phase", "dense"],
                       help="a TPU form of the JAX package; ignored")
        p.add_argument("--head_phases", type=str, default="",
                       help="a TPU form of the JAX package; ignored")
        p.add_argument("--dilated_vjp", type=str, default="",
                       choices=["", "1", "gx", "0"],
                       help="a TPU form of the JAX package; ignored")
        p.add_argument("--matmul_precision", type=str, default="default",
                       choices=["default", "high", "highest"],
                       help="the JAX package's matmul precision; ignored (the "
                            "port runs float32 with TF32 off)")
        p.add_argument("--local_rank", type=int, default=0)
        p.add_argument("--seed", type=int, default=42)
        p.add_argument("--fit_residual", action="store_true", default=False)

        # input/output sizes
        p.add_argument("--batchSize", type=int, default=1)
        p.add_argument("--loadSize", type=int, default=1024)
        p.add_argument("--fineSize", type=int, default=512)
        p.add_argument("--label_nc", type=int, default=0)
        p.add_argument("--input_nc", type=int, default=2)
        p.add_argument("--output_nc", type=int, default=1)

        # inputs / normalization
        p.add_argument("--dataroot", type=str, default="./datasets/vctk/train.csv")
        p.add_argument("--evalroot", type=str, default="./datasets/vctk/test.csv")
        p.add_argument("--serial_batches", action="store_true")
        p.add_argument("--nThreads", default=2, type=int)
        p.add_argument("--max_dataset_size", type=float, default=float("inf"))
        p.add_argument("--explicit_encoding", action="store_true")
        p.add_argument("--alpha", type=float, default=0.6)
        p.add_argument("--norm_range", type=float, default=(0, 1), nargs=2)
        p.add_argument("--abs_norm", action="store_true")
        p.add_argument("--src_range", type=float, default=(-5, 5), nargs=2)
        p.add_argument("--arcsinh_transform", action="store_true")
        p.add_argument("--raw_mdct", action="store_true")
        p.add_argument("--arcsinh_gain", type=float, default=500)
        p.add_argument("--add_noise", action="store_true")
        p.add_argument("--snr", type=float, default=55)

        # displays
        p.add_argument("--display_winsize", type=int, default=512)
        p.add_argument("--tf_log", action="store_true")

        # generator
        p.add_argument("--netG", type=str, default="global")
        p.add_argument("--ngf", type=int, default=64)
        p.add_argument("--upsample_type", type=str, default="transconv")
        p.add_argument("--downsample_type", type=str, default="conv")
        p.add_argument("--n_downsample_global", type=int, default=4)
        p.add_argument("--n_blocks_global", type=int, default=9)
        p.add_argument("--n_blocks_attn_g", type=int, default=1)
        p.add_argument("--proj_factor_g", type=int, default=4)
        p.add_argument("--dim_head_g", type=int, default=128)
        p.add_argument("--heads_g", type=int, default=4)
        p.add_argument("--n_blocks_local", type=int, default=3)
        p.add_argument("--n_blocks_attn_l", type=int, default=0)
        p.add_argument("--proj_factor_l", type=int, default=4)
        p.add_argument("--dim_head_l", type=int, default=128)
        p.add_argument("--heads_l", type=int, default=4)
        p.add_argument("--n_local_enhancers", type=int, default=1)
        p.add_argument("--niter_fix_global", type=int, default=0)

        # input mask options
        p.add_argument("--mask", action="store_true")
        p.add_argument("--smooth", type=float, default=0.0)
        p.add_argument("--mask_hr", action="store_true")
        p.add_argument("--mask_mode", type=str, default=None)
        p.add_argument("--min_value", type=float, default=1e-7)

        self.initialized = True

    def parse(self, args=None, save: bool = True):
        """Parse ``args`` (``sys.argv`` when None), print the options and,
        with ``save``, write them to ``<checkpoints_dir>/<name>/opt.txt``.
        ``gpu_ids`` becomes the list of its non-negative ids."""
        if not self.initialized:
            self.initialize()
        self.opt = self.parser.parse_args(args)
        self.opt.isTrain = self.isTrain
        str_ids = str(self.opt.gpu_ids).split(",")
        self.opt.gpu_ids = [int(s) for s in str_ids if int(s) >= 0]

        d = vars(self.opt)
        print("------------ Options -------------")
        for k, v in sorted(d.items()):
            print(f"{k}: {v}")
        print("-------------- End ----------------")

        os.makedirs(os.path.join(self.opt.checkpoints_dir, self.opt.name), exist_ok=True)
        if save:
            write_options(self.opt)
        return self.opt


def write_options(opt: argparse.Namespace) -> None:
    """``<checkpoints_dir>/<name>/opt.txt``, unless ``--continue_train``."""
    if getattr(opt, "continue_train", False):
        return
    with open(os.path.join(opt.checkpoints_dir, opt.name, "opt.txt"), "wt") as f:
        f.write("------------ Options -------------\n")
        for k, v in sorted(vars(opt).items()):
            f.write(f"{k}: {v}\n")
        f.write("-------------- End ----------------\n")


class TrainOptions(BaseOptions):
    def initialize(self):
        BaseOptions.initialize(self)
        p = self.parser
        # displays
        p.add_argument("--display_freq", type=int, default=200)
        p.add_argument("--print_freq", type=int, default=100)
        p.add_argument("--save_latest_freq", type=int, default=1000)
        p.add_argument("--save_epoch_freq", type=int, default=10)
        p.add_argument("--eval_freq", type=int, default=32000)
        p.add_argument("--loss_update_freq", type=int, default=256)
        p.add_argument("--no_html", action="store_true")
        p.add_argument("--debug", action="store_true")
        p.add_argument("--abs_spectro", action="store_true")

        # training
        p.add_argument("--continue_train", action="store_true")
        p.add_argument("--freeze_g_d", action="store_true")
        p.add_argument("--freeze_g_u", action="store_true")
        p.add_argument("--freeze_l_d", action="store_true")
        p.add_argument("--freeze_l_u", action="store_true")
        p.add_argument("--load_pretrain", type=str, default="")
        p.add_argument("--param_key_map", type=_param_key_map, default={})
        p.add_argument("--which_epoch", type=str, default="latest")
        p.add_argument("--phase", type=str, default="train")
        p.add_argument("--niter", type=int, default=100)
        p.add_argument("--niter_decay", type=int, default=100)
        p.add_argument("--niter_limit_aux", type=int, default=20)
        p.add_argument("--beta1", type=float, default=0.5)
        p.add_argument("--lr", type=float, default=0.0002)
        p.add_argument("--validation_split", type=float, default=0.05)
        p.add_argument("--val_indices", type=str)
        p.add_argument("--eval_size", type=int, default=100)
        p.add_argument("--phase_encoding_mode", type=str, default=None)

        # discriminators
        p.add_argument("--num_D", type=int, default=2)
        p.add_argument("--n_layers_D", type=int, default=3)
        p.add_argument("--ndf", type=int, default=64)
        p.add_argument("--no_ganFeat_loss", action="store_true")
        p.add_argument("--lambda_feat", type=float, default=10.0)
        p.add_argument("--no_lsgan", action="store_true")
        p.add_argument("--pool_size", type=int, default=0)

        # additions of the JAX package (no reference equivalent)
        p.add_argument("--profile_dir", type=str, default="")
        p.add_argument("--profile_step", type=int, default=8)
        p.add_argument("--profile_nsteps", type=int, default=4)
        p.add_argument("--multihost", action="store_true")
        p.add_argument("--accum_steps", type=int, default=1,
                       help="micro-batches averaged into each optimizer update")
        p.add_argument("--export_path", type=str, default="")
        p.add_argument("--export_batch", type=int, default=8)
        p.add_argument("--export_platforms", type=str, default="tpu",
                       help="the platforms the serving export is for, comma-separated: "
                            "tpu and cuda name the card, cpu the CPU; it must name the "
                            "device --gpu_ids gives")
        p.add_argument("--jax_cache_dir", type=str,
                       default=os.path.expanduser("~/.cache/mdctgan_tpu_xla"),
                       help="the JAX package's compilation cache; ignored")
        p.add_argument("--coordinator_address", type=str, default="")
        p.add_argument("--deterministic_eval", action="store_true")

        # STFT params
        p.add_argument("--lr_sampling_rate", type=int, default=LR_SAMPLE_RATE)
        p.add_argument("--hr_sampling_rate", type=int, default=HR_SAMPLE_RATE)
        p.add_argument("--sr_sampling_rate", type=int, default=SR_SAMPLE_RATE)
        p.add_argument("--segment_length", type=int, default=FRAME_LENGTH)
        p.add_argument("--gen_overlap", type=int, default=0)
        p.add_argument("--n_fft", type=int, default=N_FFT)
        p.add_argument("--bins", type=int, default=BINS)
        p.add_argument("--hop_length", type=int, default=HOP_LENGTH)
        p.add_argument("--win_length", type=int, default=WIN_LENGTH)
        p.add_argument("--center", action="store_true")
        p.add_argument("--is_lr_input", action="store_true")
        self.isTrain = True


class TestOptions(BaseOptions):
    def initialize(self):
        BaseOptions.initialize(self)
        p = self.parser
        # the reference's test flags (ONNX/TRT flags parsed and unused)
        p.add_argument("--ntest", type=float, default=float("inf"))
        p.add_argument("--results_dir", type=str, default="./results/")
        p.add_argument("--aspect_ratio", type=float, default=1.0)
        p.add_argument("--phase", type=str, default="test")
        p.add_argument("--which_epoch", type=str, default="latest")
        p.add_argument("--how_many", type=int, default=50)
        p.add_argument("--cluster_path", type=str, default="features_clustered_010.npy")
        p.add_argument("--use_encoded_image", action="store_true")
        p.add_argument("--export_onnx", type=str)
        p.add_argument("--engine", type=str)
        p.add_argument("--onnx", type=str)
        self.isTrain = False


def defaults(options=TrainOptions) -> argparse.Namespace:
    """The flags' defaults as a namespace (``gpu_ids`` still the string
    ``"0"``), without printing or writing anything."""
    o = options()
    o.initialize()
    return o.parser.parse_args([])


def as_dict(opt) -> Mapping:
    """An options dict, or ``vars()`` of a parsed namespace."""
    return opt if isinstance(opt, Mapping) else vars(opt)


def serving_devices(opt) -> List[torch.device]:
    """The devices that ``--gpu_ids`` (parsed to a list) and ``--fused_mdct``
    ask for: ``[]`` (``-1``) the CPU, ``[a, b, ..]`` ``cuda:a``, ``cuda:b``,
    ..  Raises without CUDA, ``ValueError`` for an id this host has no card
    for and for ``--fused_mdct off``."""
    o = as_dict(opt)
    if o.get("fused_mdct", "auto") == "off":
        raise ValueError("--fused_mdct off: the port always runs its MDCT kernels "
                         "on the card; use --gpu_ids -1 for the CPU")
    ids = list(o.get("gpu_ids", [0]))
    if not ids:
        return [resolve_device("cpu")]
    devices = [resolve_device(f"cuda:{i}") for i in ids]
    count = torch.cuda.device_count()
    if max(ids) >= count:
        raise ValueError(f"--gpu_ids {','.join(map(str, ids))}: this host has {count} "
                         "CUDA device(s)")
    return devices



_SPECTRAL_KEYS = (
    "n_fft", "hop_length", "win_length", "center", "lr_sampling_rate",
    "hr_sampling_rate", "sr_sampling_rate", "segment_length",
    "arcsinh_transform", "arcsinh_gain", "explicit_encoding", "alpha", "raw_mdct",
    "abs_norm", "src_range", "norm_range", "min_value", "mask", "mask_hr",
    "fit_residual", "abs_spectro",
)


def spectral_config_from_opt(opt) -> SpectralConfig:
    """``SpectralConfig`` from an options dict or a parsed namespace."""
    o = as_dict(opt)
    fields = {k: o[k] for k in _SPECTRAL_KEYS if k in o}
    for k in ("src_range", "norm_range"):
        if k in fields:
            fields[k] = tuple(float(v) for v in fields[k])
    cfg = SpectralConfig(**fields)
    if o.get("fused_mdct", "auto") == "on":
        # the dense kernels' limit on the cards --gpu_ids names, where this
        # host has them; sm_90's otherwise
        cards = [torch.device("cuda", i) for i in o.get("gpu_ids", [])
                 if torch.cuda.is_available() and i < torch.cuda.device_count()] or [None]
        if not all(fused_compatible(cfg, device=card) for card in cards):
            raise ValueError(
                "--fused_mdct on requires arcsinh_transform + abs_norm with hop = win/2 = "
                "n_fft/2, center=True, increasing src_range/norm_range and n_fft at most "
                f"{min(dense_max_n(card) for card in cards)} (the dense kernels' shared "
                "memory)")
    return cfg


# The train keys, with their flags' defaults.
TRAIN_DEFAULTS = {k: getattr(defaults(), k) for k in (
    "lr", "beta1", "niter", "niter_decay", "niter_fix_global", "ndf", "n_layers_D", "num_D",
    "lambda_feat", "no_lsgan", "no_ganFeat_loss", "pool_size", "freeze_g_d", "freeze_g_u",
    "freeze_l_d", "freeze_l_u", "fp16", "accum_steps")}


def train_options(opt) -> Dict:
    """The train keys of ``opt`` (a dict or a parsed namespace), with
    defaults."""
    o = as_dict(opt)
    return {k: o.get(k, v) for k, v in TRAIN_DEFAULTS.items()}
