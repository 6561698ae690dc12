"""Console entry points of the port:

    python -m blurry_edges_tpu_torch.cli eval [--densify w|pp] [--serve_dtype bfloat16] [--profile] ...
    python -m blurry_edges_tpu_torch.cli eval_big [--block_chunk N] ...
    python -m blurry_edges_tpu_torch.cli global_train [--attn_impl flash] ...
    python -m blurry_edges_tpu_torch.cli gen_trainval [--num_sample_train N] ...
    python -m blurry_edges_tpu_torch.cli gen_test [--big] [--num_sample_test N] ...
    python -m blurry_edges_tpu_torch.cli local_train [--epoch_num N] ...
    python -m blurry_edges_tpu_torch.cli global_precal [--model_path DIR] ...
    python -m blurry_edges_tpu_torch.cli densify_train [--pipeline] ...

The first word picks the mode; an argv that starts with a flag is
``global_train``. Each mode takes the flags of the JAX package's
counterpart (``blurry-edges-eval``, ``blurry-edges-eval-big``,
``blurry-edges-global-train``, ``blurry-edges-gen-trainval``,
``blurry-edges-gen-test``, ``blurry-edges-local-train``,
``blurry-edges-global-precal``, ``blurry-edges-densify-train``);
``--cuda`` names the device (``cpu`` for the CPU). The evaluations, the
precal and ``densify_train --pipeline`` read ``<model_path>/<name>.pth``
weights (``models/weights.py``). The chain that retrains the system for
another camera: gen_trainval, local_train (its data path is the train/val
set's ``patches/``), global_precal with the local stage it trained,
global_train, then densify_train for the ``pp`` U-Net (the same data path
as local_train; ``--epoch_num`` is ignored, 100 epochs, as in the JAX
package). ``gen_test --coco`` raises: that source is not ported.

``--dp_devices D`` (D > 1) on ``local_train``, ``global_train``, ``eval``
and ``eval_big`` starts D ranks from this process (``parallel.launch``),
each running the same mode on its share: rank r on ``cuda:r`` under NCCL
(D at most the visible cards), or under ``--cuda cpu`` on the CPU under
gloo. Rank 0 prints, writes the files and returns the result.
"""

import sys
from typing import Optional


def _needs_ranks(args) -> bool:
    """--dp_devices D > 1 asked for and this process is not one of its ranks."""
    from .parallel import in_rank

    return (args.dp_devices or 0) > 1 and not in_rank()


def _run_ranks(main, argv, args):
    """``main(argv)`` in ``args.dp_devices`` ranks; rank 0's result. No
    wall-clock limit: a training run lasts as long as its epochs do, and
    a rank that fails stops the others."""
    import torch

    from .parallel import launch

    D = args.dp_devices
    if torch.device(args.cuda).type == "cpu":
        return launch(main, D, args=(argv,))[0]
    if D > torch.cuda.device_count():
        raise SystemExit(f"--dp_devices {D}: only {torch.cuda.device_count()} CUDA devices")
    return launch(main, D, devices=[f"cuda:{r}" for r in range(D)], args=(argv,))[0]


def _mesh_from(args):
    """Inside a rank, its data mesh, with ``args.cuda`` set to the rank's
    device; else None (one device)."""
    from .parallel import in_rank, make_mesh

    if not in_rank():
        return None
    mesh = make_mesh(args.dp_devices)
    args.cuda = str(mesh.device)
    return mesh


def eval_main(argv: Optional[list] = None) -> dict:
    """147x147 evaluation with optional densification (--densify w|pp) and
    --profile tracing (reference blurry_edges_test.py:174-203)."""
    from .config import get_args
    from .eval.pipeline import run_eval
    from .eval.visualize import make_file_visualizer
    from .models.weights import load_inference_modules

    argv = list(sys.argv[1:] if argv is None else argv)
    profile = "--profile" in argv
    args = get_args("eval", argv=[a for a in argv if a != "--profile"])
    if _needs_ranks(args):
        return _run_ranks(eval_main, argv, args)
    mesh = _mesh_from(args)
    modules = load_inference_modules(args, densify=args.densify, device=args.cuda)
    return run_eval(args, modules, visualizer=make_file_visualizer(args),
                    profile_dir=f"{args.log_path}/trace" if profile else None,
                    device=args.cuda, mesh=mesh)


def eval_big_main(argv: Optional[list] = None) -> dict:
    """587x587 block-tiled evaluation (reference blurry_edges_test_big.py)."""
    from .config import get_args
    from .eval.pipeline_big import run_eval_big
    from .eval.visualize import make_file_visualizer
    from .models.weights import load_inference_modules

    argv = list(sys.argv[1:] if argv is None else argv)
    args = get_args("eval", big=True, argv=argv)
    if _needs_ranks(args):
        return _run_ranks(eval_big_main, argv, args)
    mesh = _mesh_from(args)
    modules = load_inference_modules(args, big=True, device=args.cuda)
    return run_eval_big(args, modules, visualizer=make_file_visualizer(args, big=True),
                        device=args.cuda, mesh=mesh)


def global_train_main(argv: Optional[list] = None) -> None:
    """Global-stage transformer training, --w_variant included (reference
    global_training.py:173-225)."""
    from .config import get_args
    from .train.global_ import run_global_training

    argv = list(sys.argv[1:] if argv is None else argv)
    args = get_args("global_train", argv=argv)
    if _needs_ranks(args):
        return _run_ranks(global_train_main, argv, args)
    mesh = _mesh_from(args)
    run_global_training(args, device=args.cuda, mesh=mesh)


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
    test_data_generator.py). --coco takes MS-COCO foregrounds
    (``--frgd_path``: instances_val2017.json, val2017/) over Painting
    backgrounds (``--bkgd_path``); its JPEGs are decoded by nvJPEG on a
    card and by OpenCV on the CPU."""
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

    argv = list(sys.argv[1:] if argv is None else argv)
    args = get_args("local_train", argv=argv)
    if _needs_ranks(args):
        return _run_ranks(local_train_main, argv, args)
    mesh = _mesh_from(args)
    return run_local_training(args, device=args.cuda, mesh=mesh)


def global_precal_main(argv: Optional[list] = None) -> dict:
    """The global stage's input tokens from the trained local stage
    (reference global_data_pre_cal.py)."""
    from .config import get_args
    from .train.global_precal import run_global_precal

    args = get_args("global_pre", argv=sys.argv[1:] if argv is None else argv)
    return run_global_precal(args, device=args.cuda)


def densify_train_main(argv: Optional[list] = None) -> dict:
    """Depth-completion U-Net training (the JAX package's
    depth_completion_training.py): ``local_train``'s flags, its data path
    with ``/patches`` stripped; ``--pipeline`` takes the sparse inputs from
    the trained local and global stages (``<model_path>/*.pth``), capped at
    1,500 train and 300 val maps; ``--epoch_num`` is ignored."""
    from .config import get_args
    from .train.densify import run_densify_training

    argv = list(sys.argv[1:] if argv is None else argv)
    source = "pipeline" if "--pipeline" in argv else "simulated"
    args = get_args("local_train", argv=[a for a in argv if a != "--pipeline"])
    args.data_path = args.data_path.replace("/patches", "")
    modules = max_samples = None
    if source == "pipeline":
        from .models.weights import load_inference_modules

        modules = load_inference_modules(args, device=args.cuda)
        max_samples = (1500, 300)
    return run_densify_training(args, source=source, modules=modules,
                                max_samples=max_samples, device=args.cuda)


MODES = {"eval": eval_main, "eval_big": eval_big_main, "global_train": global_train_main,
         "gen_trainval": gen_trainval_main, "gen_test": gen_test_main,
         "local_train": local_train_main, "global_precal": global_precal_main,
         "densify_train": densify_train_main}


def main(argv: Optional[list] = None):
    """Run the mode the first word names; returns what the mode returns."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and not argv[0].startswith("-"):
        if argv[0] not in MODES:
            raise SystemExit(f"unknown mode {argv[0]!r}; modes: {', '.join(MODES)}")
        return MODES[argv[0]](argv[1:])
    return global_train_main(argv)


if __name__ == "__main__":
    main()
