"""Camera, patch and patch-grid geometry (frozen dataclasses), and the
command-line arguments of the ported entry points.

Same fields, flags and defaults as the JAX package's configuration
(reference utils/args.py:3-64, utils/postprocessing_loss.py:135-137).
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class CamConfig:
    """Two-aperture thin-lens camera parameters."""

    s: float = 0.1104
    rho_1: float = 10.0
    rho_2: float = 10.2
    sigma_cam: float = 0.003
    pixel_pitch: float = 5.86e-6

    @property
    def rhos(self) -> Tuple[float, float]:
        return (self.rho_1, self.rho_2)


@dataclasses.dataclass(frozen=True)
class PatchConfig:
    """Patch geometry shared by every stage."""

    R: int = 21  # patch size
    w: float = 1.0  # wedge back-side SDF weight
    alpha_lambda: float = 5e-3  # ridge lambda = (alpha_lambda * R^2)^2
    stride: int = 2
    mag: float = 4.0

    @property
    def lambda_ridge(self) -> float:
        return (self.alpha_lambda * self.R**2) ** 2


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Patch-grid geometry for a given image size."""

    H: int = 147
    W: int = 147
    R: int = 21
    stride: int = 2

    @property
    def H_patches(self) -> int:
        return int(math.floor((self.H - self.R) / self.stride) + 1)

    @property
    def W_patches(self) -> int:
        return int(math.floor((self.W - self.R) / self.stride) + 1)

    @property
    def num_tokens(self) -> int:
        return self.H_patches * self.W_patches


# blocks of the 587x587 path that run through the networks in one pass
# (--block_chunk): the fastest of the H100 sweep in PERF.md
BLOCK_CHUNK = 4


MODES = ("data_gen_train_val", "local_train", "global_pre", "global_train",
         "data_gen_test", "eval")


def get_args(mode: str, big: bool = False, argv: Optional[list] = None) -> argparse.Namespace:
    """The argument set of one entry mode, flag for flag with the JAX
    package's ``get_args``: ``data_gen_train_val``, ``local_train``,
    ``global_pre``, ``global_train``, ``data_gen_test`` and ``eval`` (``big``
    for the 587x587 path). ``--cuda`` names the device the run uses;
    ``--block_chunk`` defaults to ``BLOCK_CHUNK``. Pass ``argv=[]`` for the
    defaults."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; modes: {', '.join(MODES)}")
    parser = argparse.ArgumentParser()
    add = parser.add_argument
    add('--cuda', type=str, default='cuda:0', help='device of the run')
    add('--model_path', type=str, default='./pretrained_weights', help='path of model weights')
    add('--img_size', type=int, nargs=2, default=[147, 147], help='image size')
    add('--big_img_size', type=int, nargs=2, default=[587, 587], help='big image size')
    add('--R', type=int, default=21, help='patch size')
    add('--w', type=float, default=1, help='w in loss function')
    add('--alpha_lambda', type=float, default=5e-3, help='rate for lambda in ridge regression')
    add('--cam_params', type=dict,
        default={'s': 0.1104, 'rho_1': 10.0, 'rho_2': 10.2,
                 'sigma_cam': 0.003, 'pixel_pitch': 5.86e-6},
        help='camera parameters')
    add('--mag', type=float, default=4, help='magnification factor')

    if mode == 'data_gen_train_val':
        add('--data_path', type=str, default='./data/data_train_val', help='path of dataset')
        add('--num_sample_train', type=int, default=8000, help='number of samples to generate in training set')
        add('--num_sample_val', type=int, default=2000, help='number of samples to generate in validation set')
        add('--num_shape', type=int, nargs=2, default=[15, 26], help='number of shapes to generate in each image')
        add('--Z_range', type=float, nargs=2, default=[0.75, 1.18], help='distance between the object and the camera (m)')
        add('--alpha', type=float, nargs=2, default=[180.0, 200.0], help='maximum average number of photons')
        add('--sigma', type=float, default=2, help='read noise coefficient')
        return parser.parse_args(argv)

    if mode == 'local_train':
        add('--data_path', type=str, default='./data/data_train_val/patches', help='path of dataset')
        add('--log_path', type=str, default='./logs', help='path of logs')
        add('--epoch_num', type=int, default=1000, help='number of epochs')
        add('--learning_rate', type=float, default=6e-5, help='initial learning rate for late training')
        add('--batch_size', type=int, default=64, help='batch size')
        add('--beta_bndry_loc', type=float, default=0.001, help='weight for boundary localization error')
        add('--beta_smthns', type=float, default=0.0005, help='weight for smoothness error')
        add('--dynamic_epoch', type=int, default=200, help='key epoch of dynamic scheduling')
        add('--dp_devices', type=int, default=0,
            help='data-parallel devices (0/1 = one device; D > 1 starts D ranks)')
        return parser.parse_args(argv)

    if mode == 'global_pre':
        add('--stride', type=int, default=2, help='stride')
        add('--data_path', type=str, default='./data/data_train_val', help='path of dataset')
        add('--batch_size', type=int, default=1, help='batch size')
        return parser.parse_args(argv)

    if mode == 'data_gen_test':
        add('--data_path', type=str, default='./data/data_test', help='path of dataset')
        add('--frgd_path', type=str, default='./data/MS_COCO_annotations/', help='path of MS COCO dataset')
        add('--bkgd_path', type=str, default='./data/Painting/', help='path of painting dataset')
        add('--num_sample_test', type=int, default=200, help='number of samples to generate in testing set')
        add('--Z_range', type=float, nargs=2, default=[0.75, 1.18], help='distance between the object and the camera (m)')
        add('--alpha', type=int, nargs=2, default=[180, 200], help='maximum average number of photons')
        add('--sigma', type=float, default=2, help='read noise coefficient')
        return parser.parse_args(argv)

    if mode == 'eval':
        add('--stride', type=int, default=2, help='stride')
        add('--log_path', type=str, default='./logs', help='path of logs')
        add('--batch_size', type=int, default=1, help='batch size')
        add('--crop', type=int, default=10, help='center crop')
        add('--rho_prime', type=float, default=10.39, help='equivalent optical power for refocusing')
        add('--densify', type=str, default=None, choices=[None, 'pp', 'w'],
            help='densification method, set None to disable')
        add('--serve_dtype', type=str, default='float32', choices=['float32', 'bfloat16'],
            help='compute dtype of the three networks (weights stay float32); the wedge, '
                 'DfD and fold chain and the confidence threshold stay float32')
        add('--vis_max', type=int, default=0,
            help='write the 10-panel visualization for only the first N pairs (0 = all)')
        add('--dp_devices', type=int, default=0,
            help='data-parallel devices (0/1 = one device; D > 1 starts D ranks)')
        if big:
            add('--n_margin_patch', type=int, default=10,
                help='number of margin patches that will be removed for global maps')
            add('--block_chunk', type=int, default=BLOCK_CHUNK,
                help='blocks run through the networks in one pass on the big path')
            add('--data_path', type=str, default='./data/data_test_big', help='path of dataset')
        else:
            add('--data_path', type=str, default='./data/data_test', help='path of dataset')
        return parser.parse_args(argv)

    add('--stride', type=int, default=2, help='stride')
    add('--data_path', type=str, default='./data/data_train_val', help='path of dataset')
    add('--log_path', type=str, default='./logs', help='path of logs')
    add('--epoch_num', type=int, default=350, help='number of epochs')
    add('--learning_rate', type=float, default=1e-4, help='initial learning rate for late training')
    add('--batch_size', type=int, default=8, help='number of batch size')
    add('--gamma_color', type=float, nargs=3, default=[1.0, 0.1, 0.1], help='weight for color error')
    add('--gamma_color_cons', type=float, nargs=3, default=[0.2, 0.1, 0.05], help='weight for color consistency error')
    add('--gamma_bndry_cons', type=float, nargs=3, default=[0.05, 0.05, 0.02], help='weight for boundary consistency error')
    add('--gamma_smthns', type=float, nargs=3, default=[0.005, 0.1, 0.002], help='weight for smothness error')
    add('--gamma_smthns_cons', type=float, nargs=3, default=[0.005, 0.1, 0.002], help='weight for smothness consistency error')
    add('--gamma_bndry_loc', type=float, nargs=3, default=[0.0001, 0.05, 0.0001], help='weight for boundary localization error')
    add('--gamma_depth', type=float, nargs=3, default=[0.0001, 0.05, 0.5], help='weight for depth error')
    add('--dynamic_epoch', type=int, nargs=3, default=[30, 100, 200], help='key epoch of dynamic scheduling')
    add('--input_size', type=int, default=38, help='input layer size')
    add('--output_size', type=int, default=12, help='output layer size')
    add('--train_subset', type=int, default=0, help='cap the train split to the first N samples (0 = all)')
    add('--val_batches', type=int, default=0, help='cap the per-epoch val sweep to N batches (0 = full sweep)')
    add('--skip_val', action='store_true', help='skip the val sweep; best-checkpoint selection falls back to the mean TRAIN loss')
    add('--snapshot_steps', type=int, default=50, help='full train-state snapshot every N optimizer steps (0 = epoch boundaries only)')
    add('--attn_impl', type=str, default='xla', choices=['xla', 'flash'],
        help="global-stage attention: 'xla' (matmul + softmax, attention-probability "
             "dropout) or 'flash' (the hand-written flash-attention kernels, no "
             "attention-probability dropout)")
    add('--time_budget_s', type=int, default=0, help='exit cleanly (snapshot + resume marker) after N seconds of training (0 = no budget)')
    add('--init_from', type=str, default=None, help='warm-start the model from this .pth checkpoint (optimizer/scheduler state starts fresh)')
    add('--w_variant', action='store_true', help="train the 'w'-variant global stage: depth term on hard wedge-side masks; saved under *_w names")
    add('--dp_devices', type=int, default=0,
        help='data-parallel devices (0/1 = one device; D > 1 starts D ranks)')
    return parser.parse_args(argv)


def cam_from_args(args: argparse.Namespace) -> CamConfig:
    cp = args.cam_params
    return CamConfig(s=cp['s'], rho_1=cp['rho_1'], rho_2=cp['rho_2'],
                     sigma_cam=cp['sigma_cam'], pixel_pitch=cp['pixel_pitch'])


def patch_from_args(args: argparse.Namespace) -> PatchConfig:
    return PatchConfig(R=args.R, w=args.w, alpha_lambda=args.alpha_lambda,
                       stride=getattr(args, 'stride', 2), mag=args.mag)


def grid_from_args(args: argparse.Namespace, big: bool = False) -> GridConfig:
    size = args.big_img_size if big else args.img_size
    return GridConfig(H=size[0], W=size[1], R=args.R, stride=getattr(args, 'stride', 2))
