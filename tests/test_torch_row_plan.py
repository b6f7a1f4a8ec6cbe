"""K1's row plan (``repro_torch.kernels.rmsnorm.row_plan``), which the
row kernels (K1, K3, K4) run by, against a brute-force statement of its
rule over every width from 1 to 20000, in float32 and bfloat16, for
aligned and unaligned rows. The plan fixes the order of the kernels' sums,
so the one thing alignment may change is the load route. The backward's
plan (``rmsnorm.bwd_plan``), which deals the rows to groups of threads and
fixes the fan-in of the dscale partials, against its own rule."""
import pytest

from repro_torch.kernels import rmsnorm
from repro_torch.kernels.rmsnorm import BwdPlan, RowPlan, aligned_rows, bwd_plan, row_plan

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


def bwd_brute_force(rows, d, elem, aligned):
    """The register route of ``row_plan`` up to 256 threads a row (narrow
    rows: one thread holding the row in 16-byte chunks), 256 / threads rows
    a block at once; else a warp a row, as many warps as fit d floats each
    in 96 KB (at least one); then the fewest blocks up to 1024 that give no
    group more than 4 rows, and the passes that take every row."""
    row = row_plan(d, elem, aligned)
    if row.route == "narrow":
        row = RowPlan("registers", 1, -(-d * elem // 16), False)
    if row.route == "registers" and row.threads <= 256:
        groups = 256 // row.threads
    else:
        row, groups = RowPlan("two-pass", 256, 1, False), max(1, min(8, 98304 // (4 * d)))
    blocks = next((b for b in range(1, 1025) if b * groups * 4 >= rows), 1024)
    return BwdPlan(row, groups, blocks, -(-rows // (blocks * groups)))


BWD_SHAPES = [(r, d) for r in (1, 3, 64, 1000, 2048, 16384, 65536, 300001)
              for d in (1, 5, 7, 8, 9, 100, 128, 2560, 5120, 8192, 16384, 20000)]


@pytest.mark.parametrize("elem", [4, 2], ids=["float32", "bfloat16"])
def test_bwd_plan_is_its_rule_and_deals_every_row_once(elem):
    for rows, d in BWD_SHAPES:
        for aligned in (True, False):
            plan = bwd_plan(rows, d, elem, aligned)
            assert plan == bwd_brute_force(rows, d, elem, aligned), (rows, d)
            # alignment changes only the load route
            u = bwd_plan(rows, d, elem, False)
            assert (u.row.route, u.row.threads, u.row.chunks) == (plan.row.route, plan.row.threads,
                                                                  plan.row.chunks)
            assert u[1:] == plan[1:]
        if rows > 70000:
            continue
        # block b's group w takes rows b·groups + w + i·blocks·groups: each row once
        per = plan.blocks * plan.groups
        dealt = sorted(b * plan.groups + w + i * per for b in range(plan.blocks)
                       for w in range(plan.groups) for i in range(plan.iters)
                       if b * plan.groups + w + i * per < rows)
        assert dealt == list(range(rows)), (rows, d)
        assert (plan.iters - 1) * per < rows <= plan.iters * per  # no pass takes no row


@pytest.mark.parametrize("rows,d,elem,plan", [
    # qwen3-4b's training step: the seams, the q- and the k-norm
    (2048, 2560, 2, BwdPlan(RowPlan("registers", 128, 3, True), 2, 256, 4)),
    (65536, 128, 2, BwdPlan(RowPlan("registers", 16, 1, True), 16, 1024, 4)),
    (16384, 128, 2, BwdPlan(RowPlan("registers", 16, 1, True), 16, 256, 4)),
    (2048, 5120, 2, BwdPlan(RowPlan("registers", 256, 3, True), 1, 512, 4)),
    (2048, 16384, 2, BwdPlan(RowPlan("two-pass", 256, 1, False), 1, 512, 4)),  # 512 threads a row
    (2048, 18432, 4, BwdPlan(RowPlan("two-pass", 256, 1, False), 1, 512, 4)),
    (5, 7, 4, BwdPlan(RowPlan("registers", 1, 2, False), 256, 1, 1)),
])
def test_bwd_plan_at_the_training_widths(rows, d, elem, plan):
    assert bwd_plan(rows, d, elem, True) == plan
    assert plan.args() == (*plan.row.args(), plan.groups, plan.blocks, plan.iters)


def test_bwd_plan_refuses_rows_past_a_blocks_shared_memory():
    bwd_plan(1, 58112, 4, False)
    with pytest.raises(ValueError, match="shared memory"):
        bwd_plan(1, 58113, 4, False)
