"""K2 (kernels/lookup_accumulate.py) vs the JAX package's Pallas table kernel.

On the CPU the wrapper runs ``lookup_accumulate_reference``, the plain
PyTorch version; it is held against ``pallas_lookup_accumulate`` in
interpret mode on distinct keys (an insert batch, a second batch that
finds them, an all-inactive batch, full buckets that drop records):
key rows and values bit-equal.  The host oracle
``lookup_accumulate_sequential`` is held against the Pallas kernel on
batches with duplicate keys, which the plain version does not take.  The
CUDA kernel itself is held against both on the card (``-m cuda``, and
chip_smoke.py).
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
    nb = NB
    if case == "insert":
        batches = [records(1000, 1024, seed=0)]
    elif case == "find-existing":
        # the second batch finds every key of the first (shuffled, with
        # new updates) and inserts none
        khi, klo, upd = records(512, 512, seed=1)
        perm = np.random.default_rng(2).permutation(512)
        batches = [(khi, klo, upd),
                   (khi[perm], klo[perm], np.float32(0.5) * upd[perm] + 1)]
    elif case == "all-inactive":
        khi, klo, upd = records(100, 256, seed=3)
        empty = np.full(256, EMPTY_HI, np.uint32)
        batches = [(khi, klo, upd), (empty, empty, np.ones(256, np.float32))]
    else:
        # 2 buckets of 128 slots for 400 keys: both fill, the rest drop
        nb = 2
        batches = [records(400, 1024, seed=4)]
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
    """On the card: bit-equal to the plain version on distinct keys and to
    the host oracle on duplicate keys; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")

    def on_card(batches, fn):
        rows, vals = empty_table()
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
    dup = [records(900, 1024, seed=11, n_distinct=300)]
    before = k2.launches
    got = on_card(distinct, k2.lookup_accumulate)
    assert k2.launches == before + 2
    assert_tables_equal(got, on_card(distinct, k2.lookup_accumulate_reference))
    assert_tables_equal(on_card(dup, k2.lookup_accumulate),
                        on_card(dup, k2.lookup_accumulate_sequential))
