"""Cross-host seed-sweep / frame-ring launcher.

``pixray_tpu.parallel.sweep`` for the port: a deterministic work
partitioner plus a runner that executes this host's shard of a sweep
through the normal engine, one session at a time (sessions on a host are
sequential; hosts run concurrently).  Sessions run on the card unless
``--device`` names another.

Usage (the YAML contract of ``python -m pixray_tpu_torch.run``):

    # host 0 of 4 renders seeds 0..63 — its contiguous quarter of them:
    python -m pixray_tpu_torch.parallel.sweep settings.yaml \
        --seeds 0-63 --num_hosts 4 --host_index 0 --outdir out/%SEED%

    # shard an animation ring's source frames across hosts: each host
    # trains the full animation engine on its contiguous span of the glob
    python -m pixray_tpu_torch.parallel.sweep anim.yaml \
        --anim_glob 'frames/*.png' --num_hosts 4 --host_index 2

``--dry_run`` prints the shard plan (one line per assigned unit) without
importing torch or touching the device.

Sharding is CONTIGUOUS (host i takes units [i*ceil(n/H), ...)): animation
frames must stay ordered and adjacent within a host because the ring blends
neighboring frames between rounds (engine/core.py ``_run_animation``) — a
host boundary costs exactly one blend edge.  Seeds have no ordering, so one
rule covers both.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys


def parse_seeds(seeds: str) -> list[int]:
    """Comma list with inclusive ranges: "1,5,8-11" -> [1, 5, 8, 9, 10, 11]."""
    out: list[int] = []
    for part in seeds.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part[1:]:  # allow a leading minus on a plain int
            lo, hi = part.rsplit("-", 1)
            lo_i, hi_i = int(lo), int(hi)
            if hi_i < lo_i:
                raise ValueError(f"empty seed range {part!r}")
            out.extend(range(lo_i, hi_i + 1))
        else:
            out.append(int(part))
    return out


def shard(units: list, num_hosts: int, host_index: int) -> list:
    """Contiguous partition: host i gets units[i*q : (i+1)*q], q=ceil(n/H).

    Deterministic in (num_hosts, host_index) only — every host computes the
    full plan locally and takes its slice, no coordination.  Trailing hosts
    may get fewer (or zero) units when n doesn't divide evenly.
    """
    if not 0 <= host_index < num_hosts:
        raise ValueError(f"host_index {host_index} not in [0, {num_hosts})")
    q = -(-len(units) // num_hosts)  # ceil division
    return units[host_index * q : (host_index + 1) * q]


def _outdir_for(template: str | None, seed) -> str | None:
    if template is None:
        return None
    return template.replace("%SEED%", str(seed))


def _run_session(settings: dict, device):
    import pixray_tpu_torch as pixray

    pixray.reset_settings()
    pixray.add_settings(**settings)
    resolved = pixray.apply_settings()
    pixray.do_init(resolved, device=device)
    pixray.do_run(resolved)


def run_seed_shard(base: dict, seeds: list[int], outdir_template: str | None, device="cuda"):
    """This host's seeds, sequentially through the normal engine."""
    for seed in seeds:
        settings = copy.deepcopy(base)
        settings["seed"] = seed
        out = _outdir_for(outdir_template, seed)
        if out is not None:
            settings["outdir"] = out
        _run_session(settings, device)


def stage_anim_shard(files: list[str], host_index: int, stage_root: str) -> str:
    """Symlink this host's contiguous frame span into a private dir and
    return the glob the engine should consume (the animation filelist is
    glob-driven — engine/core.py ``_anim_filelist`` — so a per-host
    directory IS the sharding mechanism; basenames are preserved because
    the engine names outputs after them)."""
    d = os.path.join(stage_root, f"anim_shard_{host_index}")
    os.makedirs(d, exist_ok=True)
    for f in files:
        dst = os.path.join(d, os.path.basename(f))
        if not os.path.exists(dst):
            os.symlink(os.path.abspath(f), dst)
    return os.path.join(d, "*")


def run_anim_shard(base: dict, anim_glob: str, num_hosts: int, host_index: int,
                   anim_source: str, stage_root: str, dry_run: bool, device="cuda") -> list[str]:
    from pixray_tpu_torch.utils.files import real_glob

    files = sorted(real_glob(anim_glob))
    mine = shard(files, num_hosts, host_index)
    if dry_run or not mine:
        return mine
    settings = copy.deepcopy(base)
    settings[anim_source] = stage_anim_shard(mine, host_index, stage_root)
    settings.setdefault("animation_dir", os.path.join(stage_root, f"anim_out_{host_index}"))
    _run_session(settings, device)
    return mine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("yaml", help="settings YAML (the run module's contract)")
    ap.add_argument("--seeds", default=None, help='comma list with ranges: "1,5,8-11"')
    ap.add_argument("--anim_glob", default=None,
                    help="animation source frames to shard across hosts")
    ap.add_argument("--anim_source", default="init_image",
                    help="which setting carries the frame glob (init_image/"
                         "overlay_image/...)")
    ap.add_argument("--num_hosts", type=int, default=1)
    ap.add_argument("--host_index", type=int, default=0)
    ap.add_argument("--outdir", default=None,
                    help="per-seed outdir template; %%SEED%% expands")
    ap.add_argument("--stage_dir", default="anim_shards",
                    help="where frame-span symlink dirs are staged")
    ap.add_argument("--dry_run", action="store_true",
                    help="print this host's plan, run nothing")
    ap.add_argument("--device", default="cuda", help="where the sessions run")
    args = ap.parse_args(argv)

    if (args.seeds is None) == (args.anim_glob is None):
        ap.error("give exactly one of --seeds / --anim_glob")

    base = {}
    if not args.dry_run or os.path.exists(args.yaml):
        import yaml as _yaml

        with open(args.yaml) as f:
            base = _yaml.safe_load(f) or {}

    if args.seeds is not None:
        mine = shard(parse_seeds(args.seeds), args.num_hosts, args.host_index)
        if args.dry_run:
            for seed in mine:
                out = _outdir_for(args.outdir, seed)
                print(f"host {args.host_index}/{args.num_hosts}: seed={seed}"
                      + (f" -> {out}" if out else ""))
            print(f"total {len(mine)} seeds on this host")
            return 0
        run_seed_shard(base, mine, args.outdir, args.device)
        return 0

    mine = run_anim_shard(base, args.anim_glob, args.num_hosts, args.host_index,
                          args.anim_source, args.stage_dir, args.dry_run, args.device)
    if args.dry_run:
        for f in mine:
            print(f"host {args.host_index}/{args.num_hosts}: frame={f}")
        print(f"total {len(mine)} frames on this host")
    return 0


if __name__ == "__main__":
    sys.exit(main())
