"""Vector-prompt tool: embed image sets, derive CLIP attribute directions.

``pixray_tpu.tools.vectorize`` for the port: ``--inputs`` embeds a glob of
images with every requested perceptor into a per-model JSON table;
``--avg-diff a,b`` writes mean(b) − mean(a) direction vectors;
``--svm-diff a,b`` fits a linear SVM and writes its hyperplane normal
scaled to the mean-diff length.  The output JSON is what the engine's
``--vector_prompts`` reads.

    python -m pixray_tpu_torch.tools.vectorize --models ViT-B/32 --inputs 'cats/*.png' --outfile cats.json
    python -m pixray_tpu_torch.tools.vectorize --svm-diff dogs.json,cats.json --outfile catness.json

The towers run on the card (``--device``), in bf16 there and in f32 on
the CPU.  Without ``--models`` every CLIP and SLIP tower is built.  The
SVM is solved without sklearn: the problem liblinear's ``LinearSVC(C=1.0)``
solves (``svm_normal``), by L-BFGS-B on its primal.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from pixray_tpu_torch.utils import real_glob

_perceptors: dict = {}


def init(args):
    import torch

    from pixray_tpu_torch.models.clip.configs import CLIP_CONFIGS, SLIP_CONFIGS
    from pixray_tpu_torch.models.perceptor import Perceptor

    if args.models is not None:
        args.models = [m.strip() for m in args.models.split(",")]
    else:
        args.models = [m for m in CLIP_CONFIGS if m != "TinyTest"] + sorted(SLIP_CONFIGS)
    device = torch.device(getattr(args, "device", "cuda"))
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    for name in args.models:
        _perceptors[name] = Perceptor(name, device=device, dtype=dtype)


def spew_vectors(args, inputs, outfile):
    from pixray_tpu_torch.io.images import load_image_for_perceptor

    input_files = real_glob(inputs)
    if getattr(args, "limit", None):
        input_files = input_files[: args.limit]
    save_table = {}
    for name in args.models:
        perceptor = _perceptors[name]
        print(f"Running {name} at {perceptor.input_resolution}")
        images = np.stack(
            [load_image_for_perceptor(f, perceptor.input_resolution) for f in input_files]
        )
        features = perceptor.encode_image(images).cpu().numpy()
        print(f"saving {features.shape} to {name}")
        save_table[name] = features.tolist()
    with open(outfile, "w") as fp:
        json.dump(save_table, fp)


def _read_pair(spec: str):
    f1, f2 = spec.split(",")
    with open(f1) as f_in:
        table1 = json.load(f_in)
    with open(f2) as f_in:
        table2 = json.load(f_in)
    return table1, table2


def run_avg_diff(args):
    table1, table2 = _read_pair(args.avg_diff)
    save_table = {}
    for k in table1:
        e1, e2 = np.array(table1[k]), np.array(table2[k])
        print(f"Taking the difference between {e1.shape} and {e2.shape} vectors")
        atvec = np.mean(e2, axis=0) - np.mean(e1, axis=0)
        save_table[k] = atvec.reshape(1, -1).tolist()
    with open(args.outfile, "w") as fp:
        json.dump(save_table, fp)


def svm_normal(X, y, C: float = 1.0):
    """The weights of liblinear's L2-regularized L2-loss linear SVM (sklearn's
    ``LinearSVC(C=C)``): minimize ½|w'|² + C Σ max(0, 1 − yᵢ w'·xᵢ')² over
    w' = (w, b), with labels ±1 (``y`` > 0 is the positive class) and the
    intercept as a constant feature of value 1, regularized like the
    weights.  The problem is strictly convex with a continuous gradient:
    L-BFGS-B on the primal reaches its one minimum, where liblinear stops
    at its own tolerance (1e-4)."""
    from scipy.optimize import minimize

    Xb = np.concatenate([np.asarray(X, np.float64), np.ones((len(X), 1))], axis=1)
    s = np.where(np.asarray(y) > 0, 1.0, -1.0)

    def objective(w):
        margin = np.maximum(0.0, 1.0 - s * (Xb @ w))
        return 0.5 * w @ w + C * margin @ margin, w - 2.0 * C * Xb.T @ (s * margin)

    res = minimize(objective, np.zeros(Xb.shape[1]), jac=True, method="L-BFGS-B",
                   options={"maxiter": 20000, "gtol": 1e-10, "ftol": 1e-15})
    return res.x[:-1]


def run_svm_diff(args):
    table1, table2 = _read_pair(args.svm_diff)
    save_table = {}
    for k in table1:
        e1, e2 = np.array(table1[k]), np.array(table2[k])
        print(f"Taking the svm difference between {e1.shape} and {e2.shape} vectors")
        X = np.concatenate([e1, e2], axis=0)
        y = np.concatenate([np.zeros(len(e1)), np.ones(len(e2))])
        w = svm_normal(X, y)
        # the hyperplane normal scaled to the mean-diff length
        mean_length = np.linalg.norm(np.mean(e1, axis=0) - np.mean(e2, axis=0))
        atvec = (mean_length / np.linalg.norm(w)) * w
        save_table[k] = atvec.reshape(1, -1).tolist()
    with open(args.outfile, "w") as fp:
        json.dump(save_table, fp)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Build CLIP vector prompts")
    parser.add_argument("--models", type=str, help="perceptor list", default=None, dest="models")
    parser.add_argument("--inputs", type=str, help="Images to process", default=None, dest="inputs")
    parser.add_argument("--avg-diff", dest="avg_diff", type=str, default=None, help="Two vector files to average and then diff")
    parser.add_argument("--svm-diff", dest="svm_diff", type=str, default=None, help="Two vector files for an SVM hyperplane diff")
    parser.add_argument("--outfile", type=str, help="Output JSON", default="vectors.json", dest="outfile")
    parser.add_argument("--limit", dest="limit", type=int, default=None, help="Limit number of inputs when computing atvecs")
    parser.add_argument("--device", type=str, default="cuda", help="where the towers run (--inputs)")
    # the JAX tool's flag surface: parsed and unused there too, accepted so
    # scripts written against it run unchanged
    parser.add_argument("--z-dim", dest="z_dim", type=int, default=100, help=argparse.SUPPRESS)
    parser.add_argument("--encoded-vectors", type=str, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--encoded-true", type=str, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--encoded-false", type=str, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--thresh", dest="thresh", default=False, action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--svm", dest="svm", default=False, action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--attribute-vectors", dest="attribute_vectors", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--attribute-thresholds", dest="attribute_thresholds", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--attribute-set", dest="attribute_set", default="all", help=argparse.SUPPRESS)
    parser.add_argument("--attribute-indices", dest="attribute_indices", default=None, type=str, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)

    if args.avg_diff:
        run_avg_diff(args)
    elif args.svm_diff:
        run_svm_diff(args)
    elif args.inputs:
        init(args)
        spew_vectors(args, args.inputs, args.outfile)
    else:
        parser.print_help()


if __name__ == "__main__":
    main()
