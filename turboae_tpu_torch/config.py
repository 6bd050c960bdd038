"""Typed configuration of the PyTorch port.

A copy of `turboae_tpu/config.py`'s `Config` with the same fields and
defaults, so a flag means the same thing on both sides. The port keeps its own
copy because it imports nothing of the JAX package.

Port meanings of the accelerator fields:
  - dtype='bfloat16' maps to torch.bfloat16 (conv stacks in bf16, heads f32);
  - use_fused_conv routes the decoder's plain conv stacks through the
    hand-written CUDA kernel `kernels/conv_stack.py::conv_stack_bf16`, and,
    in bf16, its dense stacks (every encoder but 'TurboAE_rate3_cnn'; JAX
    never fuses them) through `kernels/conv_stack.py::dense_stack_bf16`;
  - steps_per_call > 1 runs that many optimizer steps as one replay of a
    CUDA graph (train/trainer.py);
  - mesh_shape (N,) or (N, M) and shard_axis 'batch' | 'time' shard the
    training over torchrun's ranks (dist/mesh.py, cli/main.py); scan_unroll
    is inert here.

`get_args` parses the reference's flag surface into a `Config`, as the JAX
package's does: booleans are `--flag` (store_true), every other field is
`-flag value`, and `-mesh_shape` takes a list of ints.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Tuple

ENCODERS = (
    'Turboae_rate3_rnn',        # rate 1/3, GRU/LSTM branches (reference encoders.py:231)
    'TurboAE_rate3_rnn_sys',    # systematic bit hard-coded (encoders.py:176)
    'TurboAE_rate3_cnn',        # flagship: 3x SameShapeConv1d branches (encoders.py:306)
    'TurboAE_rate3_cnn_dense',  # DenseNet-style conv branches (encoders.py:322)
    'TurboAE_rate3_cnn2d',      # 2D conv encoder (encoders.py:505)
    'TurboAE_rate3_cnn2d_dense',
    'TurboAE_rate2_rnn',        # rate 1/2 RNN (encoders.py:128)
    'TurboAE_rate2_cnn',        # rate 1/2 CNN (encoders.py:448)
    'rate3_cnn',                # no-interleaver CNN (encoders.py:648)
    'rate3_cnn2d',              # no-interleaver 2D CNN (encoders.py:581)
    'Turbo_rate3_757',          # fixed classical turbo encoder (encoders.py:758)
    'Turbo_rate3_lte',
    'turboae_2int',             # two-interleaver variant (encoders.py:383)
)

DECODERS = (
    'TurboAE_rate3_rnn',        # reference decoders.py:16
    'TurboAE_rate3_cnn',        # flagship iterative CNN decoder (decoders.py:157)
    'TurboAE_rate3_cnn_dense',
    'TurboAE_rate3_cnn_2inter', # decoders.py:279
    'TurboAE_rate3_cnn2d',      # decoders.py:390
    'TurboAE_rate3_cnn2d_dense',
    'TurboAE_rate2_rnn',        # decoders.py:541
    'TurboAE_rate2_cnn',        # decoders.py:634
    'nbcjr_rate3',              # weight-shared NeuralBCJR (decoders.py:766)
    'rate3_cnn',                # single-pass CNN (decoders.py:733)
    'rate3_cnn2d',              # decoders.py:498
    'turboae_2int',
)

CHANNELS = ('awgn', 't-dist', 'radar', 'ge_awgn', 'bec', 'bsc', 'ge', 'fading')


@dataclass(frozen=True)
class Config:
    """Full experiment configuration: the JAX package's `Config`, field for field."""

    # model registry
    encoder: str = 'TurboAE_rate3_cnn'
    decoder: str = 'TurboAE_rate3_cnn'

    # channel (reference get_args.py:43-68)
    channel: str = 'awgn'
    vv: float = 5.0                    # t-dist dof
    radar_prob: float = 0.05
    radar_power: float = 5.0
    bec_p: float = 0.0
    bsc_p: float = 0.0
    bec_p_dec: float = 0.0
    bsc_p_dec: float = 0.0
    train_enc_channel_low: float = 1.0
    train_enc_channel_high: float = 1.0
    train_dec_channel_low: float = -1.5
    train_dec_channel_high: float = 2.0

    init_nw_weight: str = 'default'

    # code rate (k input bits -> n coded bits per step)
    code_rate_k: int = 1
    code_rate_n: int = 3

    # architecture (get_args.py:79-103)
    enc_rnn: str = 'gru'
    dec_rnn: str = 'gru'
    num_iteration: int = 6
    extrinsic: int = 1
    num_iter_ft: int = 5
    is_interleave: int = 1             # 0: none, 1: fixed seed-0, >1: random seed in [0, is_interleave)
    is_same_interleaver: int = 1
    is_parallel: int = 0               # kept for CLI parity; sharding replaces DataParallel
    enc_kernel_size: int = 5
    dec_kernel_size: int = 5
    enc_num_layer: int = 2
    dec_num_layer: int = 5
    dec_num_unit: int = 100
    enc_num_unit: int = 100
    enc_act: str = 'elu'
    dec_act: str = 'linear'
    num_ber_puncture: int = 5

    # training schedule (get_args.py:108-130)
    joint_train: int = 0
    num_train_dec: int = 5
    num_train_enc: int = 1
    dropout: float = 0.0
    snr_test_start: float = -1.5
    snr_test_end: float = 4.0
    snr_points: int = 12
    batch_size: int = 100
    num_epoch: int = 1
    test_ratio: int = 1
    block_len: int = 100
    block_len_low: int = 10
    block_len_high: int = 200
    is_variable_block_len: bool = False
    img_size: int = 10
    num_block: int = 1000

    # power-norm / STE (get_args.py:132-171)
    test_channel_mode: str = 'block_norm'
    train_channel_mode: str = 'block_norm'       # or 'block_norm_ste'
    enc_truncate_limit: float = 0.0
    enc_quantize_level: float = 2
    enc_value_limit: float = 1.0
    enc_grad_limit: float = 0.01
    enc_clipping: str = 'both'                   # inputs | gradient | both | none
    no_code_norm: bool = False

    # modulation (get_args.py:143-160)
    mod_rate: int = 2
    mod_num_layer: int = 1
    mod_num_unit: int = 20
    demod_num_layer: int = 1
    demod_num_unit: int = 20
    mod_lr: float = 0.005
    demod_lr: float = 0.005
    num_train_mod: int = 1
    num_train_demod: int = 5
    mod_pc: str = 'block_power'                  # qpsk | symbol_power | block_power

    # optimizer (get_args.py:176-179)
    optimizer: str = 'adam'                      # adam | lookahead | sgd
    dec_lr: float = 0.001
    enc_lr: float = 0.001
    momentum: float = 0.9

    # loss (get_args.py:185-197)
    loss: str = 'bce'
    ber_lambda: float = 1.0
    bce_lambda: float = 1.0
    focal_gamma: float = 0.0
    focal_alpha: float = 1.0
    lambda_maxBCE: float = 0.01

    # misc (get_args.py:202-226)
    no_cuda: bool = False              # (inert, parity) device choice is TPU/mesh-driven
    rec_quantize: bool = False
    rec_quantize_level: int = 2
    rec_quantize_limit: float = 1.0    # (inert, parity) the reference's rx STE
                                       # hard-codes +-1.0 clamp and never reads
                                       # this flag (ste.py:20, channel_ae.py:67-69)
    print_pos_ber: bool = False
    print_pos_power: bool = False
    print_test_traj: bool = False
    precompute_norm_stats: bool = False
    is_k_same_code: bool = False
    k_same_code: int = 2

    # FTAE (feedback AE) — reference ftae_get_args.py
    dec_type: str = 'turboae_cnn'      # cnn | turboae_cnn | turboae_rnn | turboae_sharedcnn
    cnn_type: str = 'normal'           # normal | dense
    ignore_feedback: bool = False
    ignore_prev_code: bool = False
    fb_channel_low: float = 10.0
    fb_channel_high: float = 10.0
    channel_mode: str = 'block_norm'   # block_norm | block_norm_ste (FTAE power constraint)
    ftae_power_alloc: str = 'none'     # none | pos | pos_phase: learned per-position
                                       # transmit-power weights on the three FORWARD
                                       # phase encoders (DeepCode's core mechanism —
                                       # the reference FTAE has only uniform whitening,
                                       # ftae_ae.py:17-36). 'pos' normalizes each
                                       # phase to unit power; 'pos_phase' normalizes
                                       # jointly so power can also shift between
                                       # phases. NOT in the reference.

    # ---- additions of the JAX package (not in the reference) ----
    dtype: str = 'float32'            # compute dtype for conv stacks: float32 | bfloat16
    mesh_shape: Tuple[int, ...] = ()  # (N,) or (N, M) ranks under torchrun (dist/mesh.py)
    shard_axis: str = 'batch'         # batch | time: the axis the mesh's data axis shards
    seed: int = 0                     # master PRNG seed
    legacy_noise: bool = False        # reproduce pre-2022 test-noise bug (README.md:2)
    use_fused_conv: bool = False      # decoder conv stacks through the CUDA bf16
                                      # conv-stack kernel (kernels/conv_stack.py)
    steps_per_call: int = 1           # optimizer steps per dispatch: one CUDA graph replay
    scan_unroll: int = 1              # (inert in the port) decoder-iteration unroll
    log_jsonl: str = ''               # if set, structured metrics written here

    def replace(self, **kw) -> 'Config':
        return dataclasses.replace(self, **kw)

    @property
    def interleaver_seed(self) -> int:
        return 0


def _add_args(parser: argparse.ArgumentParser) -> None:
    """Every Config field as a flag under the reference's spelling."""
    for f in dataclasses.fields(Config):
        default = f.default
        if isinstance(default, bool):
            parser.add_argument(f'--{f.name}', action='store_true', default=default)
        elif isinstance(default, tuple):
            parser.add_argument(f'-{f.name}', type=int, nargs='*', default=list(default))
        elif isinstance(default, (int, float)):
            parser.add_argument(f'-{f.name}', type=type(default), default=default)
        else:
            parser.add_argument(f'-{f.name}', type=str, default=default)


def config_from_args(ns: argparse.Namespace) -> Config:
    """The Config of a namespace parsed with _add_args's flags (other
    attributes of the namespace are ignored)."""
    kw = {f.name: getattr(ns, f.name) for f in dataclasses.fields(Config)}
    kw['mesh_shape'] = tuple(kw['mesh_shape'] or ())
    return Config(**kw)


def get_args(argv=None) -> Config:
    """Parse CLI flags into a Config (reference: get_args.py:4-231)."""
    parser = argparse.ArgumentParser('turboae-tpu-torch')
    _add_args(parser)
    return config_from_args(parser.parse_args(argv))
