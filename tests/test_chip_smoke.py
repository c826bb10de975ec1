"""chip_smoke.py on the CPU: without a GPU it refuses to run, and each of
its phases (except golden parity, which needs the card's speed) runs end
to end at a tiny size. The four-card phase runs on 4 virtual CPU devices.
"""
import json

import pytest

import chip_smoke


def test_main_without_gpu_exits_nonzero(capsys):
    rc = chip_smoke.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok": true' not in out
    assert out.strip() == ""


def test_phase_device():
    rec = chip_smoke.phase_device()
    json.dumps(rec)
    assert rec["platform"] == "cpu" and rec["count"] >= 1
    assert isinstance(rec["native_lib_loaded"], bool)


def test_phase_intersect_tiny():
    rec = chip_smoke.phase_intersect(n_rays=1024, n_dense=256,
                                     dragon_tris=3000, box_rays=2048)
    json.dumps(rec)
    for name in ("sweep", "bvh", "cluster"):
        assert rec[name]["disagree_with_dense"] == 0
        assert rec[name]["hits"] > 0
    assert rec["vs_cpu"]["mismatch"] == 0


def test_phase_frames_tiny():
    rec = chip_smoke.phase_frames(box_size=8, box_spp=4, dragon_size=8,
                                  dragon_spp=4, max_depth=4, dragon_tris=3000)
    json.dumps(rec)
    assert rec["renderSceneDragonBox"]["accel"] == "sweep"
    assert rec["renderSceneDragonBox"]["render_chunk_memory"] is not None
    for frame in rec.values():
        assert frame["mean_rgb"] > 0.0


def test_phase_grad_tiny():
    rec = chip_smoke.phase_grad(size=8, spp=4, max_depth=4, fd_size=8,
                                fd_spp=4, adam_size=8, adam_spp=4)
    json.dumps(rec)
    assert rec["inverse_render"]["loss_after"] < (
        rec["inverse_render"]["loss_before"])
    assert len(rec["finite_difference"]) == 2


def test_phase_demo_tiny(tmp_path):
    rec = chip_smoke.phase_demo(
        str(tmp_path), width=8, height=8, spp_min=2, spp_max=2,
        extra=("--cpu", "--no-dragon", "--max-depth", "4"),
    )
    assert (tmp_path / "demo.png").stat().st_size > 0
    assert rec["size"] == [8, 8]


def test_phase_four_on_virtual_devices(cpu_devices):
    rec = chip_smoke.phase_four(n_devices=4, size=8, spp=8, spp_min=4,
                                spp_max=8, max_depth=4, train_size=8,
                                gp_tris=1500, gp_size=8)
    json.dumps(rec)
    assert rec["mesh"] == {"dp": 2, "sp": 2}
    assert rec["geometry_parallel"]["bitwise_equal"]
    assert rec["train_step_sharded"]["moved"] > 0.0


def test_phase_four_needs_enough_devices(cpu_devices):
    with pytest.raises(chip_smoke.SmokeFailure, match="need 16 devices"):
        chip_smoke.phase_four(n_devices=16)
