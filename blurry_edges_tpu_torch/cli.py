"""Console entry points of the port. Ported so far: the global-stage trainer.

    python -m blurry_edges_tpu_torch.cli [--attn_impl flash] [--cuda cuda:0] ...

takes the flags of the JAX package's ``blurry-edges-global-train``
(reference global_training.py); ``--cuda`` names the device.
"""

import sys
from typing import Optional


def global_train_main(argv: Optional[list] = None) -> None:
    """Global-stage transformer training, --w_variant included (reference
    global_training.py:173-225)."""
    from .config import get_args
    from .train.global_ import run_global_training

    args = get_args("global_train", argv=sys.argv[1:] if argv is None else argv)
    run_global_training(args, device=args.cuda)


if __name__ == "__main__":
    global_train_main()
