"""DeepTurbo on the GPU: train a neural iterative decoder over the FIXED
classical Turbo-757 encoder (reference README 'DeepTurbo' configuration:
-encoder Turbo_rate3_757 -decoder TurboAE_rate3_cnn), as
examples/deepturbo.py does, through the PyTorch port's cli/main.py with the
same flags. It writes ./logs and ./tmp/model_<id>.msgpack.

Run (small smoke): python examples/torch_deepturbo.py
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from turboae_tpu_torch.cli import main as cli_main


def main(extra=()):
    """Returns the CLI's trainer (its last test in `last_test`)."""
    return cli_main.main(['-encoder', 'Turbo_rate3_757', '-decoder', 'TurboAE_rate3_cnn',
                          '-num_epoch', '2', '-num_block', '2000', '-batch_size', '200',
                          '-num_train_enc', '0', '-num_train_dec', '5',
                          '-snr_points', '4'] + list(extra))


if __name__ == '__main__':
    main(sys.argv[1:])
