"""YAML runner: ``python -m pixray_tpu_torch.run settings.yaml [outdir] [--device cpu]``.

The root ``run.py``'s contract for the port: one session from a YAML of
settings, on the card unless ``--device`` names another.  Run it with
``-m``: importing this module binds the attribute ``pixray_tpu_torch.run``
to it in place of the one-liner ``run()``.
"""

import argparse

import pixray_tpu_torch as pixray


def main(argv=None):
    parser = argparse.ArgumentParser(description="Run one session from a settings YAML")
    parser.add_argument("settings", help="settings YAML")
    parser.add_argument("outdir", nargs="?", default=None, help="overrides the YAML's outdir")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import yaml

    with open(args.settings) as f:
        settings = yaml.safe_load(f)
    if args.outdir is not None:
        settings["outdir"] = args.outdir

    pixray.reset_settings()
    pixray.add_settings(**settings)
    resolved = pixray.apply_settings()
    pixray.do_init(resolved, device=args.device)
    pixray.do_run(resolved)


if __name__ == "__main__":
    main()
