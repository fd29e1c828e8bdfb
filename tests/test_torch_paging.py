"""Port parity for the page bookkeeping: the same seeded alloc / share /
free / assign / extend / truncate / clear sequence goes through
``repro.serve.paging`` and ``repro_torch.serve.paging``; after every op
both hold the same state, and an op one side refuses the other refuses
with the same exception type."""

import numpy as np
import pytest

from repro.serve import paging as jpg
from repro_torch.serve import paging as tpg


def _state(alloc, table):
    return (alloc.available, alloc.in_use, sorted(alloc._refs.items()),
            list(alloc._free), table.table.tolist(),
            [table.live_len(s) for s in range(table.batch)])


def _apply(mod_alloc, mod_table, op):
    kind, args = op
    if kind in ("alloc", "share", "free"):
        return getattr(mod_alloc, kind)(*args)
    return getattr(mod_table, kind)(*args)


def _random_ops(seed, n=300, batch=4, max_pages=5, num_pages=14):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        kind = rng.choice(["alloc", "share", "free", "assign", "extend",
                           "truncate", "clear"])
        pages = [int(p) for p in rng.integers(0, num_pages,
                                              rng.integers(0, 4))]
        slot = int(rng.integers(0, batch + 1))     # batch is out of range
        if kind == "alloc":
            ops.append((kind, (int(rng.integers(-1, 5)),)))
        elif kind in ("share", "free"):
            ops.append((kind, (pages,)))
        elif kind == "assign":
            ops.append((kind, (slot, pages)))
        elif kind == "extend":
            ops.append((kind, (min(slot, batch - 1), pages)))
        elif kind == "truncate":
            ops.append((kind, (min(slot, batch - 1),
                               int(rng.integers(-1, max_pages)))))
        else:
            ops.append((kind, (min(slot, batch - 1),)))
    return ops, batch, max_pages, num_pages


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_replayed_ops_keep_identical_state(seed):
    ops, batch, max_pages, num_pages = _random_ops(seed)
    ja = jpg.PageAllocator(num_pages, reserved=1)
    ta = tpg.PageAllocator(num_pages, reserved=1)
    jt = jpg.PageTable(batch, max_pages, trash_page=0, num_pages=num_pages)
    tt = tpg.PageTable(batch, max_pages, trash_page=0, num_pages=num_pages)
    n_err = 0
    for op in ops:
        try:
            want = _apply(ja, jt, op)
            want_exc = None
        except (ValueError, IndexError, KeyError) as exc:
            want_exc = type(exc)
        if want_exc is None:
            assert _apply(ta, tt, op) == want, op
        else:
            n_err += 1
            with pytest.raises(want_exc):
                _apply(ta, tt, op)
        assert _state(ja, jt) == _state(ta, tt), op
    assert 0 < n_err < len(ops)            # both paths were exercised


@pytest.mark.parametrize("rows,page_size", [(0, 4), (1, 4), (4, 4), (5, 4),
                                            (129, 16)])
def test_pages_needed_matches(rows, page_size):
    assert tpg.pages_needed(rows, page_size) == jpg.pages_needed(rows,
                                                                 page_size)


def test_shared_pages_exempt_from_aliasing_check():
    for mod in (jpg, tpg):
        t = mod.PageTable(2, 4, num_pages=10)
        t.assign(0, [3, 4])
        with pytest.raises(ValueError, match="already live"):
            t.assign(1, [3, 5])
        t.assign(1, [3, 5], shared={3})
        assert t.row(1).tolist() == [3, 5, 0, 0]
