"""The port's EC write planning (ceph_tpu_torch.osd.ec_transaction) and
stripe hashes, twin of tests/test_rmw.py's TestPlanWrite and
TestStripeHashes, with every plan also held against
ceph_tpu.osd.ec_transaction.  The end-to-end RMW tests of that file need
the OSD and wait for the port's OSD wiring (ROADMAP Queue A item 6).
"""

import asyncio
import json

import numpy as np
import pytest

from ceph_tpu.osd import ec_transaction as ref_ec_transaction
from ceph_tpu.osd.ec_util import StripeInfo as RefStripeInfo

from ceph_tpu_torch.osd import ec_transaction
from ceph_tpu_torch.osd.ec_util import StripeHashes, StripeInfo

SW, CS = 8192, 4096  # stripe_width, chunk_size (k=2)
SINFO = StripeInfo(stripe_width=SW, chunk_size=CS)
REF_SINFO = RefStripeInfo(stripe_width=SW, chunk_size=CS)


# -- write plan (pure math) --------------------------------------------------


class TestPlanWrite:
    def test_aligned_full_stripe_overwrite_reads_nothing(self):
        p = ec_transaction.plan_write(SINFO, old_size=3 * SW, offset=SW, length=SW)
        assert p.to_read == ()
        assert p.will_write == (SW, SW)
        assert p.new_size == 3 * SW

    def test_unaligned_head_reads_head_stripe(self):
        p = ec_transaction.plan_write(SINFO, old_size=3 * SW, offset=100, length=SW)
        assert p.to_read == ((0, SW), (SW, SW))  # head + tail both partial
        assert p.will_write == (0, 2 * SW)

    def test_head_and_tail_same_stripe(self):
        p = ec_transaction.plan_write(SINFO, old_size=2 * SW, offset=10, length=20)
        assert p.to_read == ((0, SW),)
        assert p.will_write == (0, SW)
        assert p.new_size == 2 * SW

    def test_write_past_end_reads_nothing_beyond_old(self):
        # old object has 1 stripe; write starts in stripe 3: hole stripes
        # between are never read (they are zeros by contract)
        p = ec_transaction.plan_write(SINFO, old_size=SW, offset=3 * SW + 5, length=10)
        assert p.to_read == ()
        assert p.will_write == (3 * SW, SW)
        assert p.new_size == 3 * SW + 15

    def test_tail_partial_within_old(self):
        p = ec_transaction.plan_write(SINFO, old_size=4 * SW, offset=SW, length=SW + 1)
        assert p.to_read == ((2 * SW, SW),)  # only the tail stripe is partial
        assert p.will_write == (SW, 2 * SW)

    def test_old_size_mid_stripe_clips_read(self):
        # old object ends mid-stripe-2: the padded extent is 2 stripes
        p = ec_transaction.plan_write(SINFO, old_size=SW + 10, offset=SW + 5, length=3)
        assert p.to_read == ((SW, SW),)
        assert p.new_size == SW + 10

    def test_append_is_write_at_old_size(self):
        p = ec_transaction.plan_append(SINFO, old_size=SW + 10, length=100)
        assert p.to_read == ((SW, SW),)  # last stripe is partial
        assert p.will_write == (SW, SW)
        assert p.new_size == SW + 110

    def test_truncate_shrink_unaligned(self):
        p = ec_transaction.plan_truncate(SINFO, old_size=3 * SW, size=SW + 7)
        assert p.to_read == ((SW, SW),)
        assert p.will_write == (SW, SW)
        assert p.new_size == SW + 7
        assert p.shard_truncate == SINFO.aligned_logical_offset_to_chunk_offset(2 * SW)

    def test_truncate_shrink_aligned(self):
        p = ec_transaction.plan_truncate(SINFO, old_size=3 * SW, size=SW)
        assert p.to_read == ()
        assert p.will_write[1] == 0
        assert p.shard_truncate == SINFO.aligned_logical_offset_to_chunk_offset(SW)

    def test_truncate_grow_is_pure_zero_extension(self):
        p = ec_transaction.plan_truncate(SINFO, old_size=10, size=5 * SW + 3)
        assert p.to_read == ()
        assert p.will_write[1] == 0
        assert p.shard_truncate == SINFO.aligned_logical_offset_to_chunk_offset(6 * SW)

    def test_merge_extents_combines_old_and_new(self):
        plan = ec_transaction.plan_write(SINFO, old_size=SW, offset=10, length=20)
        old = bytes(range(256)) * (SW // 256)
        buf = ec_transaction.merge_extents(plan, SINFO, {0: old}, 10, b"N" * 20)
        assert buf[:10] == old[:10]
        assert buf[10:30] == b"N" * 20
        assert buf[30:] == old[30:]


class TestStripeHashes:
    def test_set_range_and_verify(self):
        sh = StripeHashes(3, 16)
        bufs = {
            i: np.frombuffer(bytes(range(i, i + 32)), dtype=np.uint8)
            for i in range(3)
        }
        sh.set_range(0, bufs)
        assert sh.num_stripes() == 2
        for i in range(3):
            assert sh.verify(i, 0, bufs[i])
            assert sh.verify(i, 1, bufs[i][16:])
            assert not sh.verify(i, 0, bufs[i][::-1].copy())

    def test_hole_fill_uses_zero_crc(self):
        sh = StripeHashes(2, 16)
        bufs = {i: np.zeros(16, dtype=np.uint8) + i for i in range(2)}
        sh.set_range(2, bufs)  # stripes 0-1 are holes
        zeros = np.zeros(32, dtype=np.uint8)
        assert sh.verify(0, 0, zeros)  # hole chunks verify as zeros
        assert sh.num_stripes() == 3

    def test_truncate_stripes(self):
        sh = StripeHashes(2, 16)
        sh.set_range(0, {i: np.zeros(64, dtype=np.uint8) for i in range(2)})
        sh.truncate_stripes(2)
        assert sh.num_stripes() == 2
        sh.truncate_stripes(5)
        assert sh.num_stripes() == 5

    def test_roundtrip_dict(self):
        sh = StripeHashes(2, 16)
        sh.set_range(0, {i: np.zeros(32, dtype=np.uint8) for i in range(2)})
        sh2 = StripeHashes.from_dict(json.loads(json.dumps(sh.to_dict())))
        assert sh2.crcs == sh.crcs and sh2.chunk_size == sh.chunk_size


# -- every planner against the reference -------------------------------------

SIZES = (0, 1, 10, SW - 1, SW, SW + 10, 3 * SW, 3 * SW + 5)


def _same_plan(port, ref):
    assert (port.to_read, port.will_write, port.new_size, port.old_size,
            port.shard_truncate) == (ref.to_read, ref.will_write,
                                     ref.new_size, ref.old_size,
                                     ref.shard_truncate)


@pytest.mark.parametrize("old_size", SIZES)
def test_plans_match_reference(old_size):
    for offset in (0, 5, SW - 3, SW, 2 * SW + 7, 5 * SW + 1):
        for length in (0, 1, 20, SW, SW + 1, 3 * SW):
            _same_plan(ec_transaction.plan_write(SINFO, old_size, offset, length),
                       ref_ec_transaction.plan_write(REF_SINFO, old_size, offset, length))
    for length in (0, 1, SW, 2 * SW + 3):
        _same_plan(ec_transaction.plan_write_full(SINFO, old_size, length),
                   ref_ec_transaction.plan_write_full(REF_SINFO, old_size, length))
        _same_plan(ec_transaction.plan_append(SINFO, old_size, length),
                   ref_ec_transaction.plan_append(REF_SINFO, old_size, length))
    for size in SIZES:
        _same_plan(ec_transaction.plan_truncate(SINFO, old_size, size),
                   ref_ec_transaction.plan_truncate(REF_SINFO, old_size, size))


def test_merge_extents_matches_reference():
    old = bytes(range(256)) * (2 * SW // 256)
    for offset, length, old_size in ((10, 20, SW), (SW - 3, 10, 2 * SW), (5, 0, 2 * SW)):
        plan = ec_transaction.plan_write(SINFO, old_size, offset, length)
        ref_plan = ref_ec_transaction.plan_write(REF_SINFO, old_size, offset, length)
        reads = {off: old[off:off + n] for off, n in plan.to_read}
        new = b"N" * length
        assert ec_transaction.merge_extents(plan, SINFO, reads, offset, new) \
            == ref_ec_transaction.merge_extents(ref_plan, REF_SINFO, reads, offset, new)
    trunc = ec_transaction.plan_truncate(SINFO, 2 * SW, SW + 7)
    ref_trunc = ref_ec_transaction.plan_truncate(REF_SINFO, 2 * SW, SW + 7)
    reads = {off: old[off:off + n] for off, n in trunc.to_read}
    assert ec_transaction.merge_extents(trunc, SINFO, reads, 0, b"") \
        == ref_ec_transaction.merge_extents(ref_trunc, REF_SINFO, reads, 0, b"")


def test_extent_locks_fifo_and_disjoint_overlap():
    """Disjoint extents hold together; an overlapping one waits; a
    waiting exclusive request blocks every later one (FIFO fairness)."""

    async def main():
        locks = ec_transaction.ExtentLocks()
        a = locks.enqueue("o", [(0, SW)])
        b = locks.enqueue("o", [(SW, SW)])
        c = locks.enqueue("o", [(0, 10)])
        full = locks.enqueue("o", ec_transaction.ExtentLocks.FULL)
        d = locks.enqueue("o", [(4 * SW, SW)])
        assert a.active and b.active and not c.active
        assert not full.active and not d.active
        locks.release("o", a.token)
        assert c.active and not full.active
        locks.release("o", b.token)
        locks.release("o", c.token)
        assert full.active and not d.active
        locks.release("o", full.token)
        await asyncio.wait_for(d.event.wait(), 1.0)
        locks.release("o", d.token)
        assert not locks.busy("o")

    asyncio.run(main())
