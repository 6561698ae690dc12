"""Faults planted in the program under a whole run, one for each fault a
cell can have: ``benchmark/test_benchmark_faults.py`` sees each make
``correct`` false on the CPU, and ``benchmark/readings.py --fault`` reads
the training cell's numbers under each on the card. Each takes a
``monkeypatch`` (pytest's, or ``pytest.MonkeyPatch()``)."""

import torch


def depth_block(monkeypatch):
    """An answer altered where it is produced, in one place: the rendered
    depth of one block of patches (a sixth of the patch grid's rows and
    of its columns, as one of the 587x587 path's 36 blocks) 1% off, the
    rest of the render sound."""
    from blurry_edges_tpu_torch.eval import pipeline, pipeline_big

    orig = pipeline.fold_outputs

    def fold_outputs(rend, grid):
        dm = rend["depth_map"].clone()
        hp, wp = max(dm.shape[-4] // 6, 1), max(dm.shape[-3] // 6, 1)
        dm[..., :hp, :wp, :, :] *= 1.01
        return orig(dict(rend, depth_map=dm), grid)

    monkeypatch.setattr(pipeline, "fold_outputs", fold_outputs)
    monkeypatch.setattr(pipeline_big, "fold_outputs", fold_outputs)


def alter_depth(monkeypatch):
    """An answer altered where it is produced: the folded depth 1% off."""
    from blurry_edges_tpu_torch.eval import pipeline, pipeline_big

    orig = pipeline.fold_outputs

    def fold_outputs(*a, **kw):
        out = orig(*a, **kw)
        out["global_depth"] = out["global_depth"] * 1.01
        return out

    monkeypatch.setattr(pipeline, "fold_outputs", fold_outputs)
    monkeypatch.setattr(pipeline_big, "fold_outputs", fold_outputs)


def half_batch(monkeypatch):
    """Half of a batched request left out: its second half answered with
    the first half's pairs."""
    from blurry_edges_tpu_torch.eval import pipeline

    orig = pipeline._as_tensor

    def as_tensor(x):
        t = orig(x).clone()
        h = t.shape[0] // 2
        t[h:] = t[:h]
        return t

    monkeypatch.setattr(pipeline, "_as_tensor", as_tensor)


def frozen_state(monkeypatch):
    """A step that returns its state unchanged: the optimizer's step does
    nothing."""
    monkeypatch.setattr(torch.optim.AdamW, "step", lambda self, closure=None: None)


def half_rows(monkeypatch):
    """Half of the batch left out, the mean taken over the rest: the second
    half of every batch's rows replaced by the first half's."""
    from blurry_edges_tpu_torch.train import global_ as tg

    orig = tg.expand_compact_batch

    def expand(batch):
        out = dict(orig(batch))
        B = out["input_param"].shape[0]
        h = B // 2
        return {k: torch.cat([v[:h], v[:h]]) if torch.is_tensor(v) and len(v) == B else v
                for k, v in out.items()}

    monkeypatch.setattr(tg, "expand_compact_batch", expand)


def altered_loss(monkeypatch):
    """An answer altered where it is produced: the loss terms 0.1% off."""
    from blurry_edges_tpu_torch.train import global_ as tg

    orig = tg.global_loss_terms

    def terms(*a, **kw):
        t, S, N = orig(*a, **kw)
        return t * 1.001, S, N

    monkeypatch.setattr(tg, "global_loss_terms", terms)

