"""The port's sweep launcher against ``pixray_tpu.parallel.sweep``.

- ``parse_seeds`` and ``shard`` equal the JAX tool's on a grid;
- ``--dry_run``'s printed plan equals the JAX tool's for a grid of argv
  (seeds and frame globs, host counts and indices), and the dry run
  imports no torch;
- ``stage_anim_shard`` links the same files under the same names;
- a real two-seed shard on the CPU writes one ``output.png`` per seed.
"""

import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import yaml

from pixray_tpu.parallel import sweep as JS
from pixray_tpu_torch.parallel import sweep as S

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seeds", ["0-6", "1,5,8-11", "-3,-1-2", "7", " 4 , ,9-9", "12-10"])
def test_parse_seeds_like_jax(seeds):
    try:
        want = JS.parse_seeds(seeds)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)):
            S.parse_seeds(seeds)
        return
    assert S.parse_seeds(seeds) == want


def test_shard_like_jax():
    for n in range(0, 12):
        for hosts in range(1, 6):
            for index in range(hosts):
                assert S.shard(list(range(n)), hosts, index) == JS.shard(list(range(n)), hosts, index)
    for bad in ((3, 3), (2, -1)):
        with pytest.raises(ValueError):
            S.shard([1], *bad)


def _plan(module, argv):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = module.main(argv)
    return rc, out.getvalue()


def test_dry_run_plan_equals_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    (tmp_path / "s.yaml").write_text("prompts: hi\n")
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(7):
        (frames / f"f{i}.png").write_bytes(b"")
    grid = []
    for hosts, index in ((1, 0), (3, 0), (3, 1), (3, 2), (4, 3), (8, 7)):
        common = ["--num_hosts", str(hosts), "--host_index", str(index), "--dry_run"]
        grid += [["s.yaml", "--seeds", "0-6"] + common,
                 ["s.yaml", "--seeds", "1,5,8-11", "--outdir", "out/%SEED%"] + common,
                 ["missing.yaml", "--seeds", "3"] + common,
                 ["s.yaml", "--anim_glob", str(frames / "*.png")] + common,
                 ["s.yaml", "--anim_glob", str(frames / "f{1,3,5}.png"), "--anim_source", "overlay_image"] + common]
    for argv in grid:
        assert _plan(S, argv) == _plan(JS, argv)
    assert _plan(S, grid[1])[1].splitlines()[0] == "host 0/1: seed=1 -> out/1"


def test_dry_run_imports_no_torch(tmp_path):
    (tmp_path / "s.yaml").write_text("prompts: hi\n")
    code = ("import sys\nfrom pixray_tpu_torch.parallel.sweep import main\n"
            f"main([{str(tmp_path / 's.yaml')!r}, '--seeds', '0-6', '--num_hosts', '3', '--host_index', '1', "
            "'--outdir', 'out/%SEED%', '--dry_run'])\n"
            f"main([{str(tmp_path / 's.yaml')!r}, '--anim_glob', {str(tmp_path / '*.yaml')!r}, '--dry_run'])\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path), env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[:4] == ["host 1/3: seed=3 -> out/3", "host 1/3: seed=4 -> out/4", "host 1/3: seed=5 -> out/5",
                         "total 3 seeds on this host"]
    assert lines[-1] == "total 1 frames on this host"


def test_stage_anim_shard_links_like_jax(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    files = []
    for i in range(5):
        (src / f"frame{i}.png").write_bytes(bytes([i]))
        files.append(str(src / f"frame{i}.png"))
    mine = S.shard(files, 2, 1)
    got = S.stage_anim_shard(mine, 1, str(tmp_path / "port"))
    want = JS.stage_anim_shard(JS.shard(files, 2, 1), 1, str(tmp_path / "jax"))
    assert os.path.relpath(got, tmp_path / "port") == os.path.relpath(want, tmp_path / "jax") == "anim_shard_1/*"
    for root in ("port", "jax"):
        d = tmp_path / root / "anim_shard_1"
        assert sorted(os.listdir(d)) == ["frame3.png", "frame4.png"]
        assert [os.readlink(d / n) for n in sorted(os.listdir(d))] == files[3:]
    assert S.stage_anim_shard(mine, 1, str(tmp_path / "port")) == got  # staging again is idempotent


def test_run_seed_shard_on_cpu(tmp_path):
    base = dict(drawer="fast_pixel", prompts="a test prompt", clip_models="TinyTest", size=[48, 32], iterations=2,
                save_every=2, display_every=2, vector_prompts="none", num_cuts=4, learning_rate_drops=[],
                steps_per_call=1)
    (tmp_path / "s.yaml").write_text(yaml.dump(base))
    template = str(tmp_path / "out" / "%SEED%")
    S.main([str(tmp_path / "s.yaml"), "--seeds", "3-6", "--num_hosts", "2", "--host_index", "1",
            "--outdir", template, "--device", "cpu"])
    assert sorted(os.listdir(tmp_path / "out")) == ["5", "6"]
    for seed in ("5", "6"):
        with open(tmp_path / "out" / seed / "output.png", "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"
