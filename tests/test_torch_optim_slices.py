"""AdamW's slicing of a layer larger than ``optim.SLICE_LAYER_ELEMS``, and
its pieces on the CPU.

An MoE layer's experts (deepseek-v2's 160 of 5120 x 1536, 1.26 B values a
layer) are one index of their stack's leading axis; the update's f32
temporaries of a whole such layer (4.7 GiB each) ran the card out of
memory beside deepseek-v2-236b's 2-layer state. Such a layer is sliced
along its next axis too. The update is elementwise, so the slices' result
is bitwise the whole leaf's; the slices cover every element once. On the
CPU each slice is updated in flat pieces of ``optim.CPU_PIECE`` elements
(its temporaries in the caches), bitwise the whole slice's update too.
"""
from __future__ import annotations

import pytest
import torch

from repro_torch.train import optim
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update


def _covered(t: torch.Tensor, limit: int):
    seen = torch.zeros(t.shape, dtype=torch.int32)
    n = 0
    for sl in optim.slices(t):
        seen[sl] += 1
        n += 1
        assert seen[sl].numel() <= max(limit, t.numel() // t.shape[0] // t.shape[1])
    return seen, n


@pytest.mark.parametrize("shape,elems,layer_limit,count", [
    ((2, 10, 7, 3), 180, 100, 2 * 2),   # layers of 210 above 100: 8 experts (168 values) a slice
    ((1, 160, 6, 4), 3072, 1000, 2),    # one MoE layer: 128 experts, then 32
    ((3, 10, 7, 3), 420, 1000, 2),      # layers under the layer limit: 2 layers a slice, as before
])
def test_a_large_layer_is_sliced_inside_and_covered_once(monkeypatch, shape, elems, layer_limit, count):
    monkeypatch.setattr(optim, "SLICE_ELEMS", elems)
    monkeypatch.setattr(optim, "SLICE_LAYER_ELEMS", layer_limit)
    t = torch.zeros(shape)
    seen, n = _covered(t, optim.SLICE_ELEMS)
    assert bool((seen == 1).all()) and n == count


def test_sliced_update_is_bitwise_the_whole_leaf_update(monkeypatch):
    g = torch.Generator().manual_seed(7)
    opt = AdamWConfig(peak_lr=0.01, warmup_steps=0, total_steps=10, mu_dtype="float32")

    def tree():
        return {"experts": torch.randn((2, 12, 9, 5), generator=g).to(torch.bfloat16),
                "s": torch.randn((), generator=g)}

    params, grads = tree(), tree()
    runs = []
    for elems, layer in ((1 << 26, 1 << 28), (100, 200)):  # whole leaves, then experts 2 at a time
        monkeypatch.setattr(optim, "SLICE_ELEMS", elems)
        monkeypatch.setattr(optim, "SLICE_LAYER_ELEMS", layer)
        p = {k: v.clone() for k, v in params.items()}
        mu, nu = adamw_init(p, opt)
        for step in range(2):
            adamw_update(grads, p, mu, nu, torch.tensor(step), opt)
        runs.append([p["experts"], mu["experts"], nu["experts"], p["s"]])
    assert len(list(optim.slices(params["experts"]))) == 12  # 2 layers x 6 slices of 2 experts
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.parametrize("piece", [7, 64, 1 << 20])
def test_cpu_pieces_are_bitwise_the_whole_slice_update(monkeypatch, piece):
    g = torch.Generator().manual_seed(3)
    opt = AdamWConfig(peak_lr=0.01, warmup_steps=0, total_steps=10, mu_dtype="bfloat16")

    def tree():
        return {"stack": torch.randn((3, 10, 9), generator=g).to(torch.bfloat16),
                "embed": torch.randn((50, 6), generator=g), "s": torch.randn((), generator=g),
                "view": torch.randn((4, 5), generator=g).t()}  # not contiguous: updated whole

    params, grads = tree(), tree()
    runs = []
    for size in (1 << 30, piece):
        monkeypatch.setattr(optim, "CPU_PIECE", size)
        p = {k: v.clone() if v.is_contiguous() else v.clone().t().contiguous().t() for k, v in params.items()}
        mu, nu = adamw_init(p, opt)
        for step in range(3):
            adamw_update(grads, p, mu, nu, torch.tensor(step), opt)
        runs.append([t for tr in (p, mu, nu) for t in (tr["stack"], tr["embed"], tr["s"], tr["view"])])
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert not torch.equal(runs[0][0], params["stack"])  # the update moved the parameters
