"""The port's CLI end to end on the CPU: ``make-bag -> map-bag --offline
--device cpu -> query`` and ``selftest``, against the JAX package's CLI
(``--backend brick --offline``) on the same bag.

Tolerances: pairs, voxel counts, cloud points and selftest stats exactly;
cloud intensities (float32 probabilities) within 1e-5, the port's float32
bar; a query of a snapshot equal to the cloud's intensity within 1e-6 (it
reads the same float32 log-odds).
"""

import json
import re

import numpy as np
import pytest

pytest.importorskip("torch")

from sonar_3d_reconstruction_tpu import cli as j_cli  # noqa: E402

from sonar_3d_reconstruction_tpu_torch import cli  # noqa: E402

PROB_TOL = 1e-5
# the JAX stream's summary keys, which a reader of either CLI's line can use
STREAM_KEYS = {
    "pings_in", "poses_in", "pairs", "frames_mapped", "decode_errors",
    "dropped_unsynced", "chunks", "grows", "fan_cap_recompiles",
    "window_cap_recompiles", "free_cap_recompiles", "box_bits_recompiles",
    "device_time", "stamp_skew_sum", "avg_stamp_skew", "latency_p50_s",
    "latency_p95_s", "latency_max_s", "wall_time", "pings_per_sec",
}
COMMON = ["--param", "max_range=5.0", "--param", "voxel_resolution=0.1",
          "--offline", "--window", "2"]


def run(capsys, main, *argv):
    rc = main(list(argv))
    out = capsys.readouterr().out
    assert rc == 0, (argv, out)
    return out


def cloud(path):
    xyzi = np.fromfile(path, "<f4").reshape(-1, 4)
    return xyzi[:, :3], xyzi[:, 3]


@pytest.mark.parametrize("ext", [".db3", ".mcap"])
def test_offline_map_and_query_match_jax_cli(tmp_path, capsys, ext):
    bag = str(tmp_path / f"survey{ext}")
    out = run(capsys, cli.main, "make-bag", bag, "--pings", "6",
              "--range-bins", "60", "--bearing-bins", "48")
    assert "6 pings" in out

    t_cloud, t_map = str(tmp_path / "t.pc2"), str(tmp_path / "t.npz")
    got = json.loads(run(capsys, cli.main, "map-bag", bag, *COMMON,
                         "--device", "cpu", "--save-cloud", t_cloud,
                         "--save-map", t_map).splitlines()[-1])
    j_cloud = str(tmp_path / "j.pc2")
    want = json.loads(run(capsys, j_cli.main, "map-bag", bag, *COMMON,
                          "--backend", "brick",
                          "--save-cloud", j_cloud).splitlines()[-1])
    assert got["pairs"] == want["pairs"] == 6
    assert got["num_voxels"] == want["num_voxels"] > 0
    assert got["device"] == "cpu" and got["bin_apply_launches"] == 0
    assert got["box_words_launches"] == 0
    pts, probs = cloud(t_cloud)
    j_pts, j_probs = cloud(j_cloud)
    assert len(pts) > 0
    np.testing.assert_array_equal(pts, j_pts)
    np.testing.assert_allclose(probs, j_probs, rtol=0, atol=PROB_TOL)

    # the float32 cloud point lies in its voxel; "--" ends the options
    # before coordinates that start with a minus sign
    x, y, z = pts[0]
    lines = run(capsys, cli.main, "query", t_map, "--device", "cpu", "--",
                f"{x},{y},{z}", "99.0,99.0,99.0").splitlines()
    rows = [json.loads(ln) for ln in lines]
    assert abs(rows[0]["probability"] - probs[0]) < 1e-6
    assert rows[1]["probability"] == 0.5
    # the JAX CLI answers the same from the port's snapshot
    j_rows = [json.loads(ln) for ln in run(
        capsys, j_cli.main, "query", t_map, "--", f"{x},{y},{z}",
        "99.0,99.0,99.0").splitlines()]
    assert [r["probability"] for r in j_rows] == [r["probability"] for r in rows]


def test_streaming_map_bag_matches_jax_cli(tmp_path, capsys):
    """map-bag without --offline: the port's stream and the JAX CLI's brick
    stream count the same pairs, chunks and voxels, publish as often, and
    save the same cloud; the port reports its device and K1 launches."""
    bag = str(tmp_path / "survey.db3")
    run(capsys, cli.main, "make-bag", bag, "--pings", "7", "--range-bins",
        "60", "--bearing-bins", "48")
    common = ["--param", "max_range=5.0", "--param", "voxel_resolution=0.1",
              "--param", "publish_rate_hz=1.0", "--chunk", "3", "--window",
              "3", "--publish"]
    t_cloud, j_cloud = str(tmp_path / "t.pc2"), str(tmp_path / "j.pc2")
    t_map = str(tmp_path / "t.npz")
    got = json.loads(run(capsys, cli.main, "map-bag", bag, *common,
                         "--device", "cpu", "--save-cloud", t_cloud,
                         "--save-map", t_map).splitlines()[-1])
    want = json.loads(run(capsys, j_cli.main, "map-bag", bag, *common,
                          "--backend", "brick",
                          "--save-cloud", j_cloud).splitlines()[-1])
    assert want.keys() <= got.keys()
    for k in ("pairs", "frames_mapped", "chunks", "decode_errors",
              "dropped_unsynced", "publishes", "last_publish_points",
              "publish_bytes"):
        assert got[k] == want[k], k
    assert (got["pairs"], got["chunks"]) == (7, 3) and got["publishes"] > 1
    assert got["device"] == "cpu" and got["bin_apply_launches"] == 0
    assert got["box_words_launches"] == 0
    pts, probs = cloud(t_cloud)
    j_pts, j_probs = cloud(j_cloud)
    assert len(pts) >= got["last_publish_points"] > 0
    np.testing.assert_array_equal(pts, j_pts)
    np.testing.assert_allclose(probs, j_probs, rtol=0, atol=PROB_TOL)
    # the snapshot holds the streamed map: the JAX CLI's offline count
    off = json.loads(run(capsys, j_cli.main, "map-bag", bag, *COMMON,
                         "--backend", "brick").splitlines()[-1])
    lines = run(capsys, cli.main, "query", t_map, "--device", "cpu", "--",
                ",".join(str(float(v)) for v in pts[0])).splitlines()
    assert abs(json.loads(lines[0])["probability"] - probs[0]) < 1e-6
    from sonar_3d_reconstruction_tpu_torch.io.checkpoint import load_map_brick

    state, _ = load_map_brick(t_map, device="cpu")
    assert int(state.used) == got["num_voxels"] == off["num_voxels"] > 0


def test_sharded_map_bag_matches_jax_cli(tmp_path, capsys):
    """map-bag --backend brick-sharded, --offline and streaming: the port
    on eight CPU shards (--shards 8) and the JAX CLI on its eight virtual
    devices count the same pairs and voxels and save the same cloud, in
    the same order; the offline snapshot holds the brick run's voxels."""
    from sonar_3d_reconstruction_tpu_torch.io.checkpoint import load_map_brick

    bag = str(tmp_path / "survey.db3")
    run(capsys, cli.main, "make-bag", bag, "--pings", "6", "--range-bins",
        "60", "--bearing-bins", "48")
    sharded = ["--backend", "brick-sharded"]
    brick = json.loads(run(capsys, cli.main, "map-bag", bag, *COMMON,
                           "--device", "cpu").splitlines()[-1])
    for mode in (COMMON, COMMON[:4] + ["--chunk", "4", "--window", "2"]):
        t_cloud, j_cloud = str(tmp_path / "t.pc2"), str(tmp_path / "j.pc2")
        t_map = str(tmp_path / "t.npz")
        got = json.loads(run(capsys, cli.main, "map-bag", bag, *mode,
                             *sharded, "--shards", "8", "--device", "cpu",
                             "--save-cloud", t_cloud,
                             "--save-map", t_map).splitlines()[-1])
        want = json.loads(run(capsys, j_cli.main, "map-bag", bag, *mode,
                              *sharded, "--save-cloud",
                              j_cloud).splitlines()[-1])
        assert got["shards"] == 8 and got["device"] == "cpu"
        assert got["pairs"] == want["pairs"] == 6
        # the JAX stream's summary has no voxel count
        assert got["num_voxels"] == want.get(
            "num_voxels", brick["num_voxels"]) == brick["num_voxels"]
        pts, probs = cloud(t_cloud)
        j_pts, j_probs = cloud(j_cloud)
        assert len(pts) > 0
        np.testing.assert_array_equal(pts, j_pts)
        np.testing.assert_allclose(probs, j_probs, rtol=0, atol=PROB_TOL)
        state, _ = load_map_brick(t_map, device="cpu")
        assert int(state.used) == brick["num_voxels"]
    one = json.loads(run(capsys, cli.main, "map-bag", bag, *COMMON,
                         *sharded, "--device", "cpu").splitlines()[-1])
    assert one["shards"] == 1 and one["num_voxels"] == brick["num_voxels"]
    with pytest.raises(SystemExit, match="--shards"):
        cli.main(["map-bag", bag, *COMMON, *sharded, "--shards", "0",
                  "--device", "cpu"])


def test_selftest_matches_jax_cli(capsys):
    """The reference self-test scenario (500x512, 3 pings) prints the same
    per-frame stats and final map as the JAX package's selftest."""
    def stats(text):
        return [re.sub(r" \([0-9.]+ ms\)", "", ln)
                for ln in text.splitlines()]

    got = stats(run(capsys, cli.main, "selftest", "--device", "cpu"))
    want = stats(run(capsys, j_cli.main, "selftest"))
    assert got[:3] == want[:3]
    assert got[3] == want[3] + " on cpu"
    assert "occupied=3716 free=26277" in got[0]


def test_commands_refuse_what_is_not_ported(tmp_path, capsys):
    bag = str(tmp_path / "s.db3")
    run(capsys, cli.main, "make-bag", bag, "--pings", "2", "--range-bins",
        "30", "--bearing-bins", "16")
    # map-bag without --offline streams the bag and prints the summary
    got = json.loads(run(capsys, cli.main, "map-bag", bag, "--device",
                         "cpu").splitlines()[-1])
    assert STREAM_KEYS <= got.keys()
    assert (got["pairs"], got["frames_mapped"], got["chunks"]) == (2, 2, 1)
    # the hash backend maps the bag to the brick backend's voxel count
    hashed = json.loads(run(capsys, cli.main, "map-bag", bag, "--device",
                            "cpu", "--backend", "hash").splitlines()[-1])
    assert hashed["num_voxels"] == got["num_voxels"] > 0
    with pytest.raises(SystemExit) as e:
        cli.main(["map-bag", bag, "--offline", "--backend", "dense"])
    assert e.value.code == 2
    # tune is left out on purpose; bench is ported (tests/test_torch_bench.py)
    with pytest.raises(SystemExit):
        cli.main(["tune"])
    assert cli.main(["query", str(tmp_path / "m.npz"), "1,2",
                     "--device", "cpu"]) == 2


@pytest.mark.parametrize("argv", [
    ["selftest"],
    ["map-bag", "BAG", "--offline"],
    ["map-bag", "BAG"],
    ["map-bag", "BAG", "--offline", "--backend", "brick-sharded"],
    ["query", "MAP", "0,0,0"],
])
def test_commands_need_the_card_unless_told(tmp_path, capsys, argv):
    """Without --device a command runs on the first CUDA device; where
    there is none it exits non-zero and names --device cpu, and never maps
    on the CPU quietly."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the command would use it")
    bag = str(tmp_path / "s.db3")
    run(capsys, cli.main, "make-bag", bag, "--pings", "2", "--range-bins",
        "30", "--bearing-bins", "16")
    snap = str(tmp_path / "m.npz")
    run(capsys, cli.main, "map-bag", bag, "--offline", "--device", "cpu",
        "--save-map", snap)
    argv = [{"BAG": bag, "MAP": snap}.get(a, a) for a in argv]
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert "CUDA is not available" in str(e.value.code)
    assert "--device cpu" in str(e.value.code)
    assert capsys.readouterr().out == ""
