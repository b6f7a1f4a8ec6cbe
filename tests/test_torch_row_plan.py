"""K1's row plan (``repro_torch.kernels.rmsnorm.row_plan``), which the
row kernels (K1, K3, K4) run by, against a brute-force statement of its
rule over every width from 1 to 20000, in float32 and bfloat16, for
aligned and unaligned rows. The plan fixes the order of the kernels' sums,
so the one thing alignment may change is the load route."""
import pytest

from repro_torch.kernels import rmsnorm
from repro_torch.kernels.rmsnorm import RowPlan, aligned_rows, row_plan

WIDTHS = range(1, 20001)


def brute_force(d, elem, aligned):
    """Among (threads, chunks a thread) with threads a power of two up to
    512 and up to 4 chunks a thread, whose chunks cover the row, and
    with more than one chunk a thread only for a warp or more: the fewest
    threads, then the fewest chunks; none fits: two passes."""
    if d <= 8:
        return RowPlan("narrow", 1, 1, False)
    per = 16 // elem
    n = -(-d // per)
    fits = [(t, c) for t in (2 ** i for i in range(10)) for c in range(1, 5)
            if t * c >= n and (c == 1 or t >= 32)]
    if not fits:
        return RowPlan("two-pass", 256, 1, False)
    t, c = min(fits)
    return RowPlan("registers", t, c, aligned and d * elem % 16 == 0)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("elem", [4, 2], ids=["float32", "bfloat16"])
def test_row_plan_is_the_brute_force_rule(elem, aligned):
    for d in WIDTHS:
        assert row_plan(d, elem, aligned) == brute_force(d, elem, aligned), d


@pytest.mark.parametrize("elem", [4, 2], ids=["float32", "bfloat16"])
def test_alignment_changes_only_the_load_route(elem):
    for d in WIDTHS:
        a, u = row_plan(d, elem, True), row_plan(d, elem, False)
        assert (a.route, a.threads, a.chunks) == (u.route, u.threads, u.chunks), d
        assert not u.vector


@pytest.mark.parametrize("d,elem,plan", [
    (5, 4, RowPlan("narrow", 1, 1, False)),            # the stream path's events
    (128, 2, RowPlan("registers", 16, 1, True)),       # qwen3-4b's qk-norm
    (128, 4, RowPlan("registers", 32, 1, True)),
    (2560, 2, RowPlan("registers", 128, 3, True)),     # d_model of qwen3-4b, zamba2-2.7b
    (5120, 2, RowPlan("registers", 256, 3, True)),     # zamba2's out_norm
    (16384, 2, RowPlan("registers", 512, 4, True)),    # the widest the registers hold
    (16385, 2, RowPlan("two-pass", 256, 1, False)),
    (8192, 4, RowPlan("registers", 512, 4, True)),
    (8193, 4, RowPlan("two-pass", 256, 1, False)),
    (18432, 4, RowPlan("two-pass", 256, 1, False)),    # nemotron-4-340b's d_model
])
def test_row_plan_at_the_serving_widths(d, elem, plan):
    assert row_plan(d, elem, True) == plan


def test_plan_arguments_and_alignment():
    assert RowPlan("registers", 16, 1, True).args() == (1, 16, 1, 1)
    assert RowPlan("narrow", 1, 1, False).args()[0] == 0
    assert RowPlan("two-pass", 256, 1, False).args()[0] == 2
    assert rmsnorm.ROUTES == ("narrow", "registers", "two-pass")
    assert aligned_rows((256, 4096), (64,), 2)
    assert not aligned_rows((256, 4098), (64,), 2)    # a base 2 bytes off
    assert not aligned_rows((256,), (129,), 2)        # an odd row stride
    assert aligned_rows((0,), (4,), 4)
