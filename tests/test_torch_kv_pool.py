"""Port parity: the paged KV pool (``serving/kv_manager.KVPagePool`` and
``PageTable``) against ``repro.serving.kv_manager``.

The reference's three pool tests (``tests/test_serving.py``) run against
the port's pool on the CPU, and one sequence of operations (admission
checks, appends across page edges, a release that returns pages to the
free list, an extract from one pool and an inject into another) leaves
both packages' pools with the same free lists, page tables, utilization,
migration bytes and page data.
"""
import numpy as np
import pytest
import torch

from repro.serving.kv_manager import KVPagePool as JKVPagePool
from repro_torch.serving import KVPagePool, PageTable


def make_pool(pages=8, page=4):
    return KVPagePool(pages, page, kv_heads=2, head_dim=8, num_layers=2,
                      device="cpu")


def test_pool_alloc_append_release():
    pool = make_pool()
    pool.allocate(0)
    for _ in range(9):                       # 9 tokens -> 3 pages of 4
        pool.append_token(0)
    assert len(pool.tables[0].pages) == 3
    assert pool.utilization == pytest.approx(3 / 8)
    pool.release(0)
    assert pool.utilization == 0.0


def test_pool_exhaustion_and_admission_check():
    pool = make_pool(pages=2, page=4)
    assert pool.can_admit(8)
    assert not pool.can_admit(9)
    pool.allocate(0)
    for _ in range(8):
        pool.append_token(0)
    with pytest.raises(MemoryError):
        pool.append_token(0)


def test_pool_migration_roundtrip():
    src, dst = make_pool(), make_pool()
    src.allocate(5)
    for t in range(6):
        pid = src.append_token(5)
        src.data[pid, :, :, t % 4] = t + 1.0
    blob = src.extract(5)
    nbytes = src.migration_bytes(5)
    assert nbytes == blob["pages"].nbytes
    dst.inject(5, blob)
    assert dst.tables[5].length == 6
    np.testing.assert_allclose(dst.data[dst.tables[5].pages],
                               src.data[src.tables[5].pages])


def test_pool_is_float32_on_the_device_asked_for():
    pool = make_pool()
    assert pool.data.dtype == torch.float32
    assert pool.data.device.type == "cpu"
    assert tuple(pool.data.shape) == (8, 2, 2, 4, 2, 8)
    assert pool.allocate(1) == PageTable(1, [], 0)
    with pytest.raises(ValueError):
        pool.allocate(1)


def test_pool_defaults_to_the_card():
    if torch.cuda.is_available():
        assert KVPagePool(2, 4, kv_heads=1, head_dim=4,
                          num_layers=1).data.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            KVPagePool(2, 4, kv_heads=1, head_dim=4, num_layers=1)


def _state(pool):
    return (list(pool.free),
            {rid: (list(pt.pages), pt.length)
             for rid, pt in pool.tables.items()},
            pool.utilization)


def test_one_sequence_of_operations_matches_the_reference():
    """Admission, appends over page edges, a release, an extract and an
    inject: free lists (their order too), page tables, utilization,
    migration bytes and page data equal after every step."""
    kw = dict(kv_heads=2, head_dim=8, num_layers=3)
    t_src, t_dst = (KVPagePool(6, 4, device="cpu", **kw) for _ in range(2))
    j_src, j_dst = (JKVPagePool(6, 4, **kw) for _ in range(2))
    rng = np.random.default_rng(0)

    def same():
        for t, j in ((t_src, j_src), (t_dst, j_dst)):
            assert _state(t) == _state(j)
            np.testing.assert_array_equal(t.data.numpy(), j.data)

    for rid in (1, 2):
        assert t_src.can_admit(9) == j_src.can_admit(9)
        t_src.allocate(rid)
        j_src.allocate(rid)
    for step, rid in enumerate([1, 1, 2, 1, 1, 2, 2, 1, 1, 2, 1]):
        pid = t_src.append_token(rid)
        assert pid == j_src.append_token(rid)
        row = rng.standard_normal((3, 2, 2, 8)).astype(np.float32)
        pos = (t_src.tables[rid].length - 1) % 4
        t_src.data[pid, :, :, pos] = torch.from_numpy(row)
        j_src.data[pid, :, :, pos] = row
        same()
    assert t_src.can_admit(9) == j_src.can_admit(9)
    assert t_src.migration_bytes(1) == j_src.migration_bytes(1)
    t_blob, j_blob = t_src.extract(1), j_src.extract(1)
    assert t_blob["length"] == j_blob["length"]
    np.testing.assert_array_equal(t_blob["pages"].numpy(), j_blob["pages"])
    assert t_blob["pages"].nbytes == j_blob["pages"].nbytes
    t_src.release(2)
    j_src.release(2)
    t_dst.allocate(7)
    j_dst.allocate(7)
    t_dst.append_token(7)
    j_dst.append_token(7)
    t_dst.inject(1, t_blob)
    j_dst.inject(1, j_blob)
    same()
    t_src.release(1)
    j_src.release(1)
    same()
    for pool in (t_dst, j_dst):
        with pytest.raises(MemoryError):
            pool.inject(9, {"length": 20, "pages": pool.data[:5]})
