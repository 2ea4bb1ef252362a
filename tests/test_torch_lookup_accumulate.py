"""K2 (kernels/lookup_accumulate.py) vs the JAX package's Pallas table kernel.

On the CPU the wrapper runs ``lookup_accumulate_plain``, the plain
PyTorch version of the kernel's rule, which takes repeated keys.  It, the
distinct-key plain version ``lookup_accumulate_reference`` and the host
oracle ``lookup_accumulate_sequential`` are held against
``pallas_lookup_accumulate`` in interpret mode (an insert batch, a second
batch that finds them, an all-inactive batch, full buckets that drop
records, repeated keys, a hot bucket): key rows and values bit-equal.
The plain version of the grouping kernels is held against the stable-sort
grouping.  The CUDA kernels themselves are held against the plain
versions on the card (``-m cuda``, and chip_smoke.py).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sonar_3d_reconstruction_tpu.ops.packing import EMPTY_HI  # noqa: E402
from sonar_3d_reconstruction_tpu.pallas import pallas_lookup_accumulate  # noqa: E402

from sonar_3d_reconstruction_tpu_torch.kernels import lookup_accumulate as k2  # noqa: E402
from sonar_3d_reconstruction_tpu_torch.ops.packing import mix2  # noqa: E402

NB = 64  # 64 buckets x 128 slots, as the JAX package's kernel tests


def records(n_active, u, seed, n_distinct=None):
    """(khi, klo, upd) numpy arrays: n_active active lanes first (drawn from
    n_distinct distinct 48-bit keys, so repeats when fewer), then inactive
    lanes."""
    rng = np.random.default_rng(seed)
    n_distinct = n_distinct or n_active
    pool = np.unique(rng.integers(0, 1 << 48, size=2 * n_distinct,
                                  dtype=np.uint64))
    pool = rng.permutation(pool)[:n_distinct]
    ks = pool[rng.integers(0, n_distinct, size=n_active)] if (
        n_distinct < n_active) else pool[:n_active]
    khi = np.full(u, EMPTY_HI, np.uint32)
    klo = np.full(u, EMPTY_HI, np.uint32)
    khi[:n_active] = (ks >> 32).astype(np.uint32)
    klo[:n_active] = (ks & 0xFFFFFFFF).astype(np.uint32)
    upd = np.zeros(u, np.float32)
    upd[:n_active] = rng.normal(size=n_active).astype(np.float32)
    return khi, klo, upd


def hot_records(n_hot, n_keys, n_other, seed, nb=NB, bucket=5):
    """(khi, klo, upd): n_hot records drawn from n_keys distinct keys that
    all fall into one bucket, mixed in random order with n_other records of
    distinct keys spread over the table and with as many inactive lanes."""
    rng = np.random.default_rng(seed)
    pool = np.unique(rng.integers(0, 1 << 48, size=400 * n_keys * nb // 64,
                                  dtype=np.int64))
    _, ids = k2.bucket_pass_reference(torch.as_tensor(pool >> 32),
                                      torch.as_tensor(pool & 0xFFFFFFFF), nb)
    ids = ids.numpy()
    hot = rng.permutation(pool[ids == bucket])[:n_keys]
    assert hot.size == n_keys, "not enough keys drawn for the hot bucket"
    other = rng.permutation(pool[ids != bucket])[:n_other]
    ks = np.concatenate([hot[rng.integers(0, n_keys, size=n_hot)], other])
    khi = np.full(2 * ks.size, EMPTY_HI, np.uint32)
    klo = np.full(2 * ks.size, EMPTY_HI, np.uint32)
    lanes = rng.permutation(2 * ks.size)[:ks.size]
    khi[lanes] = (ks >> 32).astype(np.uint32)
    klo[lanes] = (ks & 0xFFFFFFFF).astype(np.uint32)
    upd = np.zeros(2 * ks.size, np.float32)
    upd[lanes] = rng.normal(size=ks.size).astype(np.float32)
    return khi, klo, upd


def batches_of(case):
    """(record batches, NB) of the named case, applied in order."""
    if case == "insert":
        return [records(1000, 1024, seed=0)], NB
    if case == "find-existing":
        # the second batch finds every key of the first (shuffled, with
        # new updates) and inserts none
        khi, klo, upd = records(512, 512, seed=1)
        perm = np.random.default_rng(2).permutation(512)
        return [(khi, klo, upd),
                (khi[perm], klo[perm], np.float32(0.5) * upd[perm] + 1)], NB
    if case == "all-inactive":
        khi, klo, upd = records(100, 256, seed=3)
        empty = np.full(256, EMPTY_HI, np.uint32)
        return [(khi, klo, upd), (empty, empty, np.ones(256, np.float32))], NB
    if case == "full-buckets":
        # 2 buckets of 128 slots for 400 keys: both fill, the rest drop
        return [records(400, 1024, seed=4)], 2
    if case == "repeated":
        return [records(900, 1024, seed=5, n_distinct=300),
                records(600, 1024, seed=6, n_distinct=200)], NB
    if case == "hot-bucket":
        # 1500 records of 300 keys in one bucket: 128 insert, their
        # repeats accumulate, the rest drop; the second batch finds them
        return [hot_records(1500, 300, 400, seed=12),
                hot_records(700, 300, 100, seed=12)], NB
    raise ValueError(case)


def empty_table(nb=NB):
    return (np.full((nb, 256), EMPTY_HI, np.uint32),
            np.zeros((nb, 128), np.float32))


def run_pallas(batches, nb=NB):
    rows, vals = (jnp.asarray(x) for x in empty_table(nb))
    for khi, klo, upd in batches:
        rows, vals = pallas_lookup_accumulate(
            jnp.asarray(khi), jnp.asarray(klo), jnp.asarray(upd), rows, vals,
            interpret=True,
        )
    return np.asarray(rows).astype(np.int64), np.asarray(vals)


def run_port(fn, batches, nb=NB):
    rows, vals = empty_table(nb)
    rows, vals = torch.as_tensor(rows.astype(np.int64)), torch.as_tensor(vals)
    for khi, klo, upd in batches:
        rows, vals = fn(
            torch.as_tensor(khi.astype(np.int64)),
            torch.as_tensor(klo.astype(np.int64)), torch.as_tensor(upd),
            rows, vals,
        )
    return rows.numpy(), vals.numpy()


def assert_tables_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0], err_msg="key_rows")
    np.testing.assert_array_equal(got[1], want[1], err_msg="values")


@pytest.mark.parametrize("fn", ["reference", "sequential"])
@pytest.mark.parametrize("case", ["insert", "find-existing", "all-inactive",
                                  "full-buckets"])
def test_matches_pallas_on_distinct_keys(fn, case):
    """Distinct keys: the plain version and the host oracle lay out the
    table and accumulate the values exactly as the Pallas kernel does."""
    batches, nb = batches_of(case)
    port_fn = (k2.lookup_accumulate_reference if fn == "reference"
               else k2.lookup_accumulate_sequential)
    got = run_port(port_fn, batches, nb)
    want = run_pallas(batches, nb)
    assert_tables_equal(got, want)
    n_keys = int((got[0][:, :128] != EMPTY_HI).sum())
    expect = {"insert": 1000, "find-existing": 512, "all-inactive": 100,
              "full-buckets": 256}[case]
    assert n_keys == expect


def test_sequential_oracle_matches_pallas_on_duplicate_keys():
    """Repeated keys in one batch: a later record finds the slot an earlier
    one inserted, as in the TPU kernel's sequential loop."""
    batches = [records(900, 1024, seed=5, n_distinct=300),
               records(600, 1024, seed=6, n_distinct=200)]
    assert_tables_equal(
        run_port(k2.lookup_accumulate_sequential, batches), run_pallas(batches)
    )


@pytest.mark.parametrize("case", ["insert", "find-existing", "all-inactive",
                                  "full-buckets", "repeated", "hot-bucket"])
def test_plain_version_matches_pallas(case):
    """The plain version of the kernel's rule, which the wrapper runs on
    the CPU, takes repeated keys and hot buckets: the same tables as the
    Pallas kernel, bit for bit."""
    batches, nb = batches_of(case)
    assert_tables_equal(run_port(k2.lookup_accumulate_plain, batches, nb),
                        run_pallas(batches, nb))


@pytest.mark.parametrize("case", ["insert", "find-existing", "all-inactive",
                                  "full-buckets"])
def test_plain_version_matches_reference_on_distinct_keys(case):
    batches, nb = batches_of(case)
    assert_tables_equal(run_port(k2.lookup_accumulate_plain, batches, nb),
                        run_port(k2.lookup_accumulate_reference, batches, nb))


def grouping_case(case):
    """(khi, klo, upd) numpy arrays and NB of a grouping case."""
    if case == "spread":
        # active and inactive lanes interleaved
        khi, klo, upd = records(700, 1024, seed=7)
        perm = np.random.default_rng(8).permutation(1024)
        return khi[perm], klo[perm], upd[perm], NB
    if case == "empty-buckets":
        return (*records(20, 64, seed=13), NB)
    if case == "hot-bucket":
        return (*hot_records(1500, 300, 400, seed=12), NB)
    if case == "one-bucket":
        return (*records(300, 512, seed=14, n_distinct=100), 1)
    return (*records(0, 256, seed=15), NB)


@pytest.mark.parametrize("case", ["spread", "empty-buckets", "hot-bucket",
                                  "one-bucket", "all-inactive"])
def test_grouped_records_follow_the_stable_sort(case):
    """The plain version of the grouping kernels (bucket pass, scan,
    scatter, record order restored) gives the stable sort's segments and
    order, each record's words packed beside its index."""
    khi, klo, upd, nb = grouping_case(case)
    t_hi, t_lo = (torch.as_tensor(x.astype(np.int64)) for x in (khi, klo))
    packed, seg = k2.group_records_reference(t_hi, t_lo,
                                             torch.as_tensor(upd), nb)
    order, seg_sorted = k2.group_by_bucket(t_hi, t_lo, nb)
    active = khi != EMPTY_HI
    n_active = int(active.sum())
    seg_sorted = seg_sorted.numpy()
    np.testing.assert_array_equal(seg[:, 0].numpy(), seg_sorted[:-1])
    np.testing.assert_array_equal(seg[:, 1].numpy(), np.diff(seg_sorted))
    assert seg.dtype == torch.int32 and int(seg[:, 1].sum()) == n_active
    rec, order = packed[:n_active].numpy(), order[:n_active].numpy()
    np.testing.assert_array_equal(rec[:, 3], order)
    np.testing.assert_array_equal(rec[:, 0].view(np.uint32), khi[order])
    np.testing.assert_array_equal(rec[:, 1].view(np.uint32), klo[order])
    np.testing.assert_array_equal(rec[:, 2].view(np.float32), upd[order])
    counts, _ = k2.bucket_pass_reference(t_hi, t_lo, nb)
    np.testing.assert_array_equal(seg[:, 1].numpy(), counts.numpy())
    # unpacked, they are the active records in record order
    for got, want in zip(k2.unpack_records(packed, seg), (khi, klo, upd)):
        np.testing.assert_array_equal(got.numpy().astype(want.dtype),
                                      want[active])


def test_table_kernel_plain_version_on_grouped_records():
    """``apply_grouped`` on the CPU (the table kernel's plain version)
    gives the whole function's tables from grouped records, whatever the
    order within a segment."""
    khi, klo, upd = records(900, 1024, seed=16, n_distinct=300)
    t = [torch.as_tensor(x.astype(np.int64)) for x in (khi, klo)]
    t.append(torch.as_tensor(upd))
    packed, seg = k2.group_records_reference(*t, NB)
    # reverse each segment, as the scatter's atomics may leave it
    rev = torch.cat([packed[int(a):int(a) + int(n)].flip(0) for a, n in seg])
    rows, vals = (torch.as_tensor(x) for x in empty_table())
    rows = rows.to(torch.int64)
    got = k2.apply_grouped(rev, seg, rows, vals)
    assert_tables_equal((got[0].numpy(), got[1].numpy()),
                        run_port(k2.lookup_accumulate_plain, [(khi, klo, upd)]))


def test_group_by_bucket_keeps_record_order():
    """Segments hold exactly each bucket's active records, in record order;
    inactive records come last."""
    khi, klo, _ = records(700, 1024, seed=7)
    t_hi, t_lo = (torch.as_tensor(x.astype(np.int64)) for x in (khi, klo))
    order, seg = k2.group_by_bucket(t_hi, t_lo, NB)
    bucket = (mix2(t_hi, t_lo) & (NB - 1)).numpy()
    order, seg = order.numpy(), seg.numpy()
    assert seg[0] == 0 and seg[-1] == 700
    for b in range(NB):
        np.testing.assert_array_equal(
            order[seg[b]:seg[b + 1]], np.flatnonzero(bucket[:700] == b)
        )
    np.testing.assert_array_equal(np.sort(order[700:]), np.arange(700, 1024))


def test_wrapper_on_cpu_runs_the_plain_version():
    khi, klo, upd = records(300, 512, seed=8)
    before = k2.launches
    got = run_port(k2.lookup_accumulate, [(khi, klo, upd)])
    want = run_port(k2.lookup_accumulate_reference, [(khi, klo, upd)])
    assert k2.launches == before
    assert_tables_equal(got, want)


@pytest.mark.parametrize("bad", ["key_dtype", "upd_dtype", "lengths",
                                 "buckets", "values_shape", "devices"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    khi, klo, upd = records(50, 64, seed=9)
    rows, vals = empty_table()
    args = dict(khi=torch.as_tensor(khi.astype(np.int64)),
                klo=torch.as_tensor(klo.astype(np.int64)),
                upd=torch.as_tensor(upd),
                key_rows=torch.as_tensor(rows.astype(np.int64)),
                values=torch.as_tensor(vals))
    if bad == "key_dtype":
        args["khi"] = args["khi"].to(torch.int32)
    elif bad == "upd_dtype":
        args["upd"] = args["upd"].double()
    elif bad == "lengths":
        args["klo"] = args["klo"][:-1]
    elif bad == "buckets":
        args["key_rows"] = args["key_rows"][:48]
        args["values"] = args["values"][:48]
    elif bad == "values_shape":
        args["values"] = args["values"][:, :64]
    else:
        args["upd"] = args["upd"].to("meta")
    with pytest.raises((TypeError, ValueError)):
        k2.lookup_accumulate(**args)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version_and_oracle():
    """On the card: bit-equal to the plain versions on distinct keys, and
    to the host oracle and the plain version of the kernel's rule on
    repeated keys and a hot bucket (whose segment is sorted by its own
    kernel); the grouping kernels give the plain grouping's segments; one
    table-kernel launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def on_card(batches, fn, nb=NB):
        rows, vals = empty_table(nb)
        rows = torch.as_tensor(rows.astype(np.int64), device="cuda")
        vals = torch.as_tensor(vals, device="cuda")
        for khi, klo, upd in batches:
            rows, vals = fn(
                *(torch.as_tensor(x.astype(np.int64), device="cuda")
                  for x in (khi, klo)),
                torch.as_tensor(upd, device="cuda"), rows, vals,
            )
        return rows.cpu().numpy(), vals.cpu().numpy()

    distinct = [records(1000, 1024, seed=10), records(1000, 1024, seed=10)]
    before = k2.launches
    got = on_card(distinct, k2.lookup_accumulate)
    assert k2.launches == before + 2
    assert_tables_equal(got, on_card(distinct, k2.lookup_accumulate_reference))
    for case in ("repeated", "hot-bucket", "full-buckets"):
        batches, nb = batches_of(case)
        got = on_card(batches, k2.lookup_accumulate, nb)
        assert_tables_equal(
            got, on_card(batches, k2.lookup_accumulate_sequential, nb))
        assert_tables_equal(
            got, on_card(batches, k2.lookup_accumulate_plain, nb))
    for case in ("spread", "empty-buckets", "hot-bucket", "one-bucket",
                 "all-inactive"):
        khi, klo, upd, nb = grouping_case(case)
        t = [torch.as_tensor(x.astype(np.int64)) for x in (khi, klo)]
        t.append(torch.as_tensor(upd))
        packed, seg = k2.group_records(*(x.cuda() for x in t), nb)
        want = k2.group_records_reference(*t, nb)
        # segments may lie in another order on the card, not hold others
        np.testing.assert_array_equal(seg[:, 1].cpu().numpy(),
                                      want[1][:, 1].numpy())
        for a, b in zip(k2.unpack_records(packed.cpu(), seg.cpu()),
                        k2.unpack_records(*want)):
            assert torch.equal(a, b)
