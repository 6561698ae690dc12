"""Console entry points of the port:

    python -m blurry_edges_tpu_torch.cli eval [--densify w|pp] [--serve_dtype bfloat16] [--profile] ...
    python -m blurry_edges_tpu_torch.cli eval_big [--block_chunk N] ...
    python -m blurry_edges_tpu_torch.cli global_train [--attn_impl flash] ...
    python -m blurry_edges_tpu_torch.cli gen_trainval [--num_sample_train N] ...
    python -m blurry_edges_tpu_torch.cli gen_test [--big] [--num_sample_test N] ...
    python -m blurry_edges_tpu_torch.cli local_train [--epoch_num N] ...
    python -m blurry_edges_tpu_torch.cli global_precal [--model_path DIR] ...

The first word picks the mode; an argv that starts with a flag is
``global_train``. Each mode takes the flags of the JAX package's
counterpart (``blurry-edges-eval``, ``blurry-edges-eval-big``,
``blurry-edges-global-train``, ``blurry-edges-gen-trainval``,
``blurry-edges-gen-test``, ``blurry-edges-local-train``,
``blurry-edges-global-precal``); ``--cuda`` names the device (``cpu`` for
the CPU). The evaluations and the precal read ``<model_path>/<name>.pth``
weights (``utils/weights.py``). The chain that retrains the system for
another camera: gen_trainval, local_train (its data path is the train/val
set's ``patches/``), global_precal with the local stage it trained, then
global_train. ``gen_test --coco`` raises: that source is not ported.
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


def gen_trainval_main(argv: Optional[list] = None) -> dict:
    """Basic-shape train/val sets: scenes, noise, patch crops (reference
    train_val_data_generator.py); returns the seconds of each phase."""
    from .config import get_args
    from .data.shapes_gen import SEED, SyntheticShapeDataGenerator
    from .utils.seeding import set_seed

    args = get_args("data_gen_train_val", argv=sys.argv[1:] if argv is None else argv)
    set_seed(SEED)
    return SyntheticShapeDataGenerator(args, device=args.cuda).run()


def gen_test_main(argv: Optional[list] = None) -> None:
    """A realistic layered-defocus test set; --big for 587x587, written to
    the data path with ``data_test`` read as ``data_test_big`` (reference
    test_data_generator.py). --coco raises NotImplementedError."""
    from .config import get_args
    from .data.realistic_gen import SyntheticRealisticDataGenerator

    argv = list(sys.argv[1:] if argv is None else argv)
    big = "--big" in argv
    source = "coco" if "--coco" in argv else "synthetic"
    argv = [a for a in argv if a not in ("--big", "--coco")]
    args = get_args("data_gen_test", argv=argv)
    if big:
        args.data_path = args.data_path.replace("data_test", "data_test_big")
    SyntheticRealisticDataGenerator(args, big=big, source=source,
                                    device=args.cuda).generate_synthetic_data()


def local_train_main(argv: Optional[list] = None) -> dict:
    """Local-stage CNN training (reference local_training.py:68-122)."""
    from .config import get_args
    from .train.local import run_local_training

    args = get_args("local_train", argv=sys.argv[1:] if argv is None else argv)
    return run_local_training(args, device=args.cuda)


def global_precal_main(argv: Optional[list] = None) -> dict:
    """The global stage's input tokens from the trained local stage
    (reference global_data_pre_cal.py)."""
    from .config import get_args
    from .train.global_precal import run_global_precal

    args = get_args("global_pre", argv=sys.argv[1:] if argv is None else argv)
    return run_global_precal(args, device=args.cuda)


MODES = {"eval": eval_main, "eval_big": eval_big_main, "global_train": global_train_main,
         "gen_trainval": gen_trainval_main, "gen_test": gen_test_main,
         "local_train": local_train_main, "global_precal": global_precal_main}


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
