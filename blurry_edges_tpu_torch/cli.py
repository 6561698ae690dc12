"""Console entry points of the port:

    python -m blurry_edges_tpu_torch.cli eval [--densify w|pp] [--serve_dtype bfloat16] [--profile] ...
    python -m blurry_edges_tpu_torch.cli eval_big [--block_chunk N] ...
    python -m blurry_edges_tpu_torch.cli global_train [--attn_impl flash] ...

The first word picks the mode; an argv that starts with a flag is
``global_train``. Each mode takes the flags of the JAX package's
counterpart (``blurry-edges-eval``, ``blurry-edges-eval-big``,
``blurry-edges-global-train``); ``--cuda`` names the device (``cpu`` for
the CPU). The evaluations read ``<model_path>/<name>.pth`` weights
(``utils/weights.py::load_inference_modules``).
"""

import sys
from typing import Optional


def eval_main(argv: Optional[list] = None) -> dict:
    """147x147 evaluation with optional densification (--densify w|pp) and
    --profile tracing (reference blurry_edges_test.py:174-203)."""
    from .config import get_args
    from .eval.pipeline import run_eval
    from .eval.visualize import make_file_visualizer
    from .utils.weights import load_inference_modules

    argv = list(sys.argv[1:] if argv is None else argv)
    profile = "--profile" in argv
    argv = [a for a in argv if a != "--profile"]
    args = get_args("eval", argv=argv)
    modules = load_inference_modules(args, densify=args.densify, device=args.cuda)
    return run_eval(args, modules, visualizer=make_file_visualizer(args),
                    profile_dir=f"{args.log_path}/trace" if profile else None,
                    device=args.cuda)


def eval_big_main(argv: Optional[list] = None) -> dict:
    """587x587 block-tiled evaluation (reference blurry_edges_test_big.py)."""
    from .config import get_args
    from .eval.pipeline_big import run_eval_big
    from .eval.visualize import make_file_visualizer
    from .utils.weights import load_inference_modules

    args = get_args("eval", big=True, argv=sys.argv[1:] if argv is None else argv)
    modules = load_inference_modules(args, big=True, device=args.cuda)
    return run_eval_big(args, modules, visualizer=make_file_visualizer(args, big=True),
                        device=args.cuda)


def global_train_main(argv: Optional[list] = None) -> None:
    """Global-stage transformer training, --w_variant included (reference
    global_training.py:173-225)."""
    from .config import get_args
    from .train.global_ import run_global_training

    args = get_args("global_train", argv=sys.argv[1:] if argv is None else argv)
    run_global_training(args, device=args.cuda)


MODES = {"eval": eval_main, "eval_big": eval_big_main, "global_train": global_train_main}


def main(argv: Optional[list] = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and not argv[0].startswith("-"):
        if argv[0] not in MODES:
            raise SystemExit(f"unknown mode {argv[0]!r}; modes: {', '.join(MODES)}")
        MODES[argv[0]](argv[1:])
    else:
        global_train_main(argv)


if __name__ == "__main__":
    main()
