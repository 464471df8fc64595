"""Reproduce the reference's BibTeX convergence experiment.

The reference's only published empirical claim is the convergence plot in
``/root/reference/example/example_stochqn.ipynb`` (README.md "Comparison"):
multinomial logistic regression on the BibTeX dataset from the Extreme
Classification Repository (7,395 samples, 1,836 features, 159 labels),
trained in 148 batches of 50 via ``partial_fit``, comparing test-set loss
per accessed data points for SGD, RMSProp, oLBFGS and adaQN — with adaQN's
``max_incr`` guard observed firing (``func_increased``) around iterations
60/100/120.

This script replays that experiment verbatim against OUR guided layer:
same hyperparameters (steps 1e-1/1e-2/1e-2/1e-1, reg 1e-1, rmsprop_weight
0.9, no step decay), same sklearn-layout multinomial loss/gradient, same
seed-1 initialization and shuffle.

Data: the real ``Bibtex_data.txt`` cannot be fetched here (no network
egress); pass ``--data /path/to/Bibtex_data.txt`` to run on the real
dataset via :func:`stochqn_tpu.utils.data.parse_extreme_classification`.
Without it, a documented synthetic fallback with BibTeX's exact shape and
sparsity (binary features, ~68 active/row, topic-structured labels) is
generated; trajectories are then qualitatively comparable (quasi-Newton
methods beating SGD/RMSProp per data touched; adaQN max_incr events
firing), not numerically identical to the notebook's plot.

Run: python benchmarks/bibtex_convergence.py [--data F] [--out J] [--plot P]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
# protocol-on-CPU experiment; it never needs the GPU.
# No persistent compile cache: the shared CPU cache holds AOT entries
# compiled for other hosts' CPU features (see CLAUDE.md), which XLA will
# load with a SIGILL/wrong-numerics warning; compiles here are cheap.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)   # the notebook runs float64

import numpy as np


# --------------------------------------------------------------------------
# sklearn-layout multinomial loss/grad (the notebook used sklearn's private
# _multinomial_loss_grad; same math, w = [n_classes, n_features + 1] flat,
# intercept in the last column, L2 penalty on the non-intercept block)
# --------------------------------------------------------------------------
def _prob(w, X, n_classes):
    W = w.reshape(n_classes, -1)
    coef, icept = W[:, :-1], W[:, -1]
    z = X @ coef.T + icept
    z -= z.max(axis=1, keepdims=True)
    p = np.exp(z)
    p /= p.sum(axis=1, keepdims=True)
    return p, coef


def obj_fun(w, X, Y, sample_weight=None, reg_param=0.1):
    n_classes = Y.shape[1]
    sw = np.ones(X.shape[0]) if sample_weight is None else sample_weight
    p, coef = _prob(w, X, n_classes)
    ll = -(sw[:, None] * Y * np.log(p + 1e-300)).sum()
    return ll + 0.5 * reg_param * (coef ** 2).sum()


def grad_fun(w, X, Y, sample_weight=None, reg_param=0.1):
    n_classes = Y.shape[1]
    sw = np.ones(X.shape[0]) if sample_weight is None else sample_weight
    p, coef = _prob(w, X, n_classes)
    diff = sw[:, None] * (p - Y)
    g_coef = diff.T @ X + reg_param * coef
    g_icept = diff.sum(axis=0)
    return np.concatenate([g_coef, g_icept[:, None]], axis=1).ravel()


# --------------------------------------------------------------------------
# synthetic BibTeX-shaped fallback
# --------------------------------------------------------------------------
def synthetic_bibtex(n=7395, d=1836, n_labels=159, seed=0):
    """Binary bag-of-words with topic structure at BibTeX's shape/sparsity:
    ~68 active features per row, 2-3 labels per row, labels predictable
    from features (so optimizers have signal to exploit)."""
    rng = np.random.default_rng(seed)
    n_topics = 30
    topic_feats = rng.integers(0, d, size=(n_topics, 120))
    topic_labels = rng.integers(0, n_labels, size=(n_topics, 3))
    X = np.zeros((n, d), np.float64)
    Y = np.zeros((n, n_labels), np.int8)
    z = rng.integers(0, n_topics, size=n)
    for i in range(n):
        k_topic = rng.integers(30, 55)
        feats = np.concatenate([
            rng.choice(topic_feats[z[i]], size=k_topic, replace=False),
            rng.integers(0, d, size=68 - k_topic)])
        X[i, feats] = 1.0
        n_lab = rng.integers(2, 4)
        Y[i, rng.choice(topic_labels[z[i]], size=min(n_lab, 3),
                        replace=False)] = 1
    return X, Y


def synthetic_bibtex_structured(n=7395, d=1836, n_labels=159, rank=16,
                                seed=0):
    """BibTeX-like statistics the flat topic fallback lacks: real tag data
    has POWER-LAW feature and label marginals and LOW-RANK label
    co-occurrence (tags co-fire through a few latent themes).  Both properties matter to the optimizer comparison: Zipfian
    feature frequencies make the gradient covariance ill-conditioned
    (rare-but-informative features), which is the regime where a
    quasi-Newton rescaling can beat SGD per data point.

    Construction: latent theme vector z_i ~ N(0, I_rank) per row;
    features sampled without replacement from softmax(z_i A + log pop)
    with pop ~ Zipf(0.9) (~68 active/row, matching BibTeX); labels
    Bernoulli(sigmoid(z_i U + b)) with b set for Zipfian label marginals
    and ~2.4 labels/row.  Labels are predictable from features only
    through the shared rank-``rank`` latent — low-rank co-occurrence by
    construction.
    """
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, d + 1) ** 0.9
    log_pop = np.log(pop / pop.sum())
    A = rng.normal(size=(rank, d)) * 1.2
    U = rng.normal(size=(rank, n_labels)) * 2.0
    # Zipfian label bias: sigmoid(b_j) ~ freq_j, freq ~ 1/(j+3)^0.8
    lab_freq = 1.0 / (np.arange(n_labels) + 3.0) ** 0.8
    lab_freq *= 2.4 / lab_freq.sum()          # ~2.4 labels/row on average
    b = np.log(lab_freq / (1 - np.minimum(lab_freq, 0.5)))

    Z = rng.normal(size=(n, rank))
    X = np.zeros((n, d), np.float64)
    Y = np.zeros((n, n_labels), np.int8)
    for i in range(n):
        logits = Z[i] @ A + log_pop * 3.0
        logits -= logits.max()
        p = np.exp(logits)
        p /= p.sum()
        k = int(rng.integers(50, 86))          # ~68 active features
        X[i, rng.choice(d, size=k, replace=False, p=p)] = 1.0
        pl = 1.0 / (1.0 + np.exp(-(Z[i] @ U + b)))
        yi = rng.random(n_labels) < pl
        if not yi.any():
            yi[np.argmax(pl)] = True
        Y[i, yi] = 1
    return X, Y


def early_advantage(curve_opt, curve_sgd, window_frac=0.33):
    """Quantify the reference plot's qualitative claim — the quasi-Newton
    beating SGD *early* in training: fraction of the first third of the
    batches where its test loss is below SGD's, and the first batch index
    where it pulls ahead (None if never)."""
    w = max(1, int(len(curve_sgd) * window_frac))
    opt = np.asarray(curve_opt[:w])
    sgd = np.asarray(curve_sgd[:w])
    ahead = opt < sgd
    first = int(np.argmax(ahead)) if ahead.any() else None
    return {"window_batches": w,
            "frac_ahead_of_sgd": round(float(ahead.mean()), 3),
            "first_batch_ahead": first}


def _merge_write(path, updates):
    """Merge keys into the output JSON instead of clobbering prior
    runs."""
    out = {}
    if os.path.exists(path):
        with open(path) as f:
            out = json.load(f)
    out.update(updates)
    with open(path, "w") as f:
        json.dump(out, f, indent=1)


def sweep_olbfgs(args, X, Y, source):
    """SGD-vs-oLBFGS early-advantage sweep over oLBFGS step sizes (the
    notebook fixed 1e-2 and said the steps "haven't been tuned very
    well"; the reference claim under test is oLBFGS beating SGD early —
    README.md:13-15 / plot/bibtex.png)."""
    from sklearn.model_selection import train_test_split
    from stochqn_tpu.guided import oLBFGS

    steps = [float(s) for s in args.sweep_olbfgs.split(",")]
    X_tr, X_te, Y_tr, Y_te = train_test_split(X, Y, test_size=0.1,
                                              random_state=1)
    reg_param = 1e-1
    np.random.seed(1)
    w0 = np.random.normal(size=(X.shape[1] + 1) * Y.shape[1])
    order = np.argsort(np.random.random(size=X_tr.shape[0]))
    X_tr, Y_tr = X_tr[order], Y_tr[order]
    sw_te = np.ones(X_te.shape[0])
    kw = {"reg_param": reg_param}
    batch_size = 50
    nbatches = int(np.ceil(X_tr.shape[0] / batch_size))

    # one SGD baseline (notebook step 1e-1), shared across the sweep
    w_sgd = w0.copy()
    sgd_curve = []
    batches = []
    for b in range(nbatches):
        st, end = b * batch_size, min(X_tr.shape[0], (b + 1) * batch_size)
        Xb, Yb = X_tr[st:end], Y_tr[st:end]
        batches.append((Xb, Yb))
        w_sgd -= 1e-1 * grad_fun(w_sgd, Xb, Yb, None, reg_param)
        sgd_curve.append(obj_fun(w_sgd, X_te, Y_te, sw_te, reg_param))

    runs = {}
    for step in steps:
        ol = oLBFGS(x0=w0.copy(), grad_fun=grad_fun, obj_fun=obj_fun,
                    step_size=step, decr_step_size=None, verbose=False,
                    backend=args.backend)
        curve = []
        for b, (Xb, Yb) in enumerate(batches):
            ol.partial_fit(Xb, Yb, np.ones(Xb.shape[0]),
                           additional_kwargs=kw)
            curve.append(obj_fun(ol.x, X_te, Y_te, sw_te, reg_param))
        adv = early_advantage(curve, sgd_curve)
        runs[f"{step:g}"] = {
            "final_loss": round(float(curve[-1]), 2),
            "early_advantage": adv,
            "curve": [round(float(v), 2) for v in curve],
        }
        print(f"oLBFGS step {step:g}: final {curve[-1]:.0f} "
              f"(SGD {sgd_curve[-1]:.0f}), early-window frac ahead "
              f"{adv['frac_ahead_of_sgd']}", flush=True)

    best = max(runs.items(),
               key=lambda kv: kv[1]["early_advantage"]["frac_ahead_of_sgd"])
    _merge_write(args.out, {f"olbfgs_step_sweep_{source}": {
        "note": ("reference claim under test: oLBFGS < SGD early in "
                 "training (README plot).  frac_ahead_of_sgd = fraction "
                 "of the first third of batches where oLBFGS's test "
                 "loss is below SGD's (step 1e-1, as the notebook)"),
        "sgd_final_loss": round(float(sgd_curve[-1]), 2),
        "sgd_curve": [round(float(v), 2) for v in sgd_curve],
        "runs": runs,
        "best_step": best[0],
        "claim_reproduced": best[1]["early_advantage"]
        ["frac_ahead_of_sgd"] >= 0.5,
    }})
    print(f"best step {best[0]}: frac ahead "
          f"{best[1]['early_advantage']['frac_ahead_of_sgd']}")


def sweep_sgd(args, X, Y, source):
    """Tune the SGD (and RMSProp) baselines the oLBFGS sweep is scored
    against (the notebook's SGD step 1e-1 DIVERGES on the structured
    synthetic, so beating it would be trivially satisfiable).
    Sweeps SGD/RMSProp steps with the exact same split/seed/batches as
    :func:`sweep_olbfgs`, flags diverging runs, then re-scores every
    recorded oLBFGS curve against the best NON-diverging SGD and RMSProp.
    The reference claim survives only if oLBFGS still shows the early
    advantage against the tuned baselines."""
    from sklearn.model_selection import train_test_split

    sgd_steps = [float(s) for s in args.sweep_sgd.split(",")]
    rms_steps = [1e-1, 3e-2, 1e-2, 3e-3, 1e-3]
    X_tr, X_te, Y_tr, Y_te = train_test_split(X, Y, test_size=0.1,
                                              random_state=1)
    reg_param = 1e-1
    np.random.seed(1)
    w0 = np.random.normal(size=(X.shape[1] + 1) * Y.shape[1])
    order = np.argsort(np.random.random(size=X_tr.shape[0]))
    X_tr, Y_tr = X_tr[order], Y_tr[order]
    sw_te = np.ones(X_te.shape[0])
    batch_size = 50
    nbatches = int(np.ceil(X_tr.shape[0] / batch_size))
    batches = [(X_tr[b * batch_size:(b + 1) * batch_size],
                Y_tr[b * batch_size:(b + 1) * batch_size])
               for b in range(nbatches)]
    f0 = float(obj_fun(w0, X_te, Y_te, sw_te, reg_param))

    def run_sgd(step):
        w = w0.copy()
        curve = []
        for Xb, Yb in batches:
            w -= step * grad_fun(w, Xb, Yb, None, reg_param)
            curve.append(float(obj_fun(w, X_te, Y_te, sw_te, reg_param)))
        return curve

    def run_rmsprop(step):
        w = w0.copy()
        acc = np.zeros_like(w)
        curve = []
        for Xb, Yb in batches:
            g = grad_fun(w, Xb, Yb, None, reg_param)
            acc = 0.9 * acc + 0.1 * g ** 2
            w -= step * g / np.sqrt(acc + 1e-4)
            curve.append(float(obj_fun(w, X_te, Y_te, sw_te, reg_param)))
        return curve

    def classify(curve):
        # diverging = worse than the w0 loss at the end, or non-finite
        final = curve[-1]
        return (not np.isfinite(final)) or final > f0

    sgd_runs, rms_runs = {}, {}
    for step in sgd_steps:
        c = run_sgd(step)
        sgd_runs[f"{step:g}"] = {"final_loss": round(c[-1], 2),
                                 "diverged": classify(c),
                                 "curve": [round(v, 2) for v in c]}
        print(f"SGD step {step:g}: final {c[-1]:.0f}"
              f"{' DIVERGED' if classify(c) else ''}", flush=True)
    for step in rms_steps:
        c = run_rmsprop(step)
        rms_runs[f"{step:g}"] = {"final_loss": round(c[-1], 2),
                                 "diverged": classify(c),
                                 "curve": [round(v, 2) for v in c]}
        print(f"RMSProp step {step:g}: final {c[-1]:.0f}"
              f"{' DIVERGED' if classify(c) else ''}", flush=True)

    def best_of(runs):
        ok = {k: v for k, v in runs.items() if not v["diverged"]}
        if not ok:
            return None
        return min(ok.items(), key=lambda kv: kv[1]["final_loss"])

    best_sgd = best_of(sgd_runs)
    best_rms = best_of(rms_runs)

    # re-score the recorded oLBFGS sweep against the tuned baselines
    result = {
        "note": ("fair-baseline rematch: SGD/RMSProp steps swept exactly "
                 "like oLBFGS's were; 'diverged' = final test loss above "
                 "the w0 loss; oLBFGS curves from "
                 f"olbfgs_step_sweep_{source} re-scored against the best "
                 "non-diverging baselines"),
        "w0_loss": round(f0, 2),
        "sgd_runs": sgd_runs,
        "rmsprop_runs": rms_runs,
        "best_sgd_step": best_sgd[0] if best_sgd else None,
        "best_rmsprop_step": best_rms[0] if best_rms else None,
    }

    prior = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            prior = json.load(f)
    ol_sweep = prior.get(f"olbfgs_step_sweep_{source}", {}).get("runs", {})
    if ol_sweep and best_sgd:
        rematch = {}
        for step, rec in ol_sweep.items():
            adv = early_advantage(rec["curve"], best_sgd[1]["curve"])
            entry = {"vs_tuned_sgd": adv,
                     "final_ratio_vs_tuned_sgd": round(
                         rec["final_loss"] / best_sgd[1]["final_loss"], 3)}
            if best_rms:
                entry["vs_tuned_rmsprop"] = early_advantage(
                    rec["curve"], best_rms[1]["curve"])
                entry["final_ratio_vs_tuned_rmsprop"] = round(
                    rec["final_loss"] / best_rms[1]["final_loss"], 3)
            rematch[step] = entry
        best_ol = max(rematch.items(),
                      key=lambda kv: kv[1]["vs_tuned_sgd"]
                      ["frac_ahead_of_sgd"])
        result["olbfgs_rematch"] = rematch
        result["best_olbfgs_step_vs_tuned"] = best_ol[0]
        result["claim_vs_tuned_sgd"] = (
            best_ol[1]["vs_tuned_sgd"]["frac_ahead_of_sgd"] >= 0.5)
        print(f"best oLBFGS step vs tuned SGD: {best_ol[0]} "
              f"(frac ahead {best_ol[1]['vs_tuned_sgd']['frac_ahead_of_sgd']},"
              f" final ratio {best_ol[1]['final_ratio_vs_tuned_sgd']})")

    _merge_write(args.out, {f"sgd_step_sweep_{source}": result})


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data", default=None,
                    help="path to real Bibtex_data.txt (XC format)")
    ap.add_argument("--structured", action="store_true",
                    help="use the structured synthetic fallback (power-law "
                         "marginals + low-rank label co-occurrence)")
    ap.add_argument("--sweep-sgd", default=None,
                    help="comma-separated SGD step sizes: tune the "
                         "SGD/RMSProp baselines and re-score the recorded "
                         "oLBFGS sweep against the best non-diverging ones")
    ap.add_argument("--sweep-olbfgs", default=None,
                    help="comma-separated oLBFGS step sizes: run an "
                         "SGD-vs-oLBFGS early-advantage sweep instead of "
                         "the full four-optimizer replay")
    ap.add_argument("--out", default="bibtex_convergence.json")
    ap.add_argument("--plot", default=None, help="optional output PNG")
    ap.add_argument("--backend", default="jax", choices=["jax", "native"])
    args = ap.parse_args()

    from sklearn.model_selection import train_test_split
    from stochqn_tpu.guided import adaQN, oLBFGS

    if args.data:
        from stochqn_tpu.utils.data import parse_extreme_classification
        X, Y = parse_extreme_classification(args.data)
        X = np.asarray(X.todense(), np.float64)
        source = "real"
    elif args.structured:
        X, Y = synthetic_bibtex_structured()
        source = "synthetic_structured"
    else:
        X, Y = synthetic_bibtex()
        source = "synthetic"
    print(f"dataset: {source}, X {X.shape}, Y {Y.shape}")

    if args.sweep_sgd:
        sweep_sgd(args, X, Y, source)
        return
    if args.sweep_olbfgs:
        sweep_olbfgs(args, X, Y, source)
        return

    X_tr, X_te, Y_tr, Y_te = train_test_split(X, Y, test_size=0.1,
                                              random_state=1)
    reg_param = 1e-1
    np.random.seed(1)
    w0 = np.random.normal(size=(X.shape[1] + 1) * Y.shape[1])
    order = np.argsort(np.random.random(size=X_tr.shape[0]))
    X_tr, Y_tr = X_tr[order], Y_tr[order]

    w_sgd, w_rms = w0.copy(), w0.copy()
    step_sgd, step_rms, step_ol, step_ada = 1e-1, 1e-2, 1e-2, 1e-1
    reg_rms, wdiv_rms = 1e-4, 0.9
    acc_rms = np.zeros_like(w_rms)

    adaqn = adaQN(x0=w0.copy(), grad_fun=grad_fun, obj_fun=obj_fun,
                  step_size=step_ada, decr_step_size=None,
                  rmsprop_weight=0.9, verbose=False, backend=args.backend)
    olbfgs = oLBFGS(x0=w0.copy(), grad_fun=grad_fun, obj_fun=obj_fun,
                    step_size=step_ol, decr_step_size=None, verbose=False,
                    backend=args.backend)

    # record every non-clean iteration_info the protocol reports for adaQN
    events = []
    inner_run = adaqn.optimizer.run_optimizer

    def spy(x, step):
        req = inner_run(x, step)
        info = req["info"]["iteration_info"]
        if info != "no_problems_encountered":
            events.append((int(adaqn.optimizer.niter), info))
        return req
    adaqn.optimizer.run_optimizer = spy

    kw = {"reg_param": reg_param}
    batch_size = 50
    nbatches = int(np.ceil(X_tr.shape[0] / batch_size))
    curves = {"sgd": [], "rmsprop": [], "olbfgs": [], "adaqn": []}
    sw_te = np.ones(X_te.shape[0])
    for b in range(nbatches):
        st, end = b * batch_size, min(X_tr.shape[0], (b + 1) * batch_size)
        Xb, Yb = X_tr[st:end], Y_tr[st:end]
        swb = np.ones(Xb.shape[0])

        w_sgd -= step_sgd * grad_fun(w_sgd, Xb, Yb, swb, reg_param)
        g = grad_fun(w_rms, Xb, Yb, swb, reg_param)
        acc_rms = wdiv_rms * acc_rms + (1 - wdiv_rms) * g ** 2
        w_rms -= step_rms * g / np.sqrt(acc_rms + reg_rms)

        adaqn.partial_fit(Xb, Yb, swb, additional_kwargs=kw)
        olbfgs.partial_fit(Xb, Yb, swb, additional_kwargs=kw)

        curves["sgd"].append(obj_fun(w_sgd, X_te, Y_te, sw_te, reg_param))
        curves["rmsprop"].append(obj_fun(w_rms, X_te, Y_te, sw_te, reg_param))
        curves["adaqn"].append(obj_fun(adaqn.x, X_te, Y_te, sw_te, reg_param))
        curves["olbfgs"].append(obj_fun(olbfgs.x, X_te, Y_te, sw_te,
                                        reg_param))
        if (b + 1) % 25 == 0:
            print(f"batch {b + 1}/{nbatches}: " + "  ".join(
                f"{k}={v[-1]:.0f}" for k, v in curves.items()))

    func_incr = [it for it, info in events if info == "func_increased"]
    out = {
        "source": source,
        "shape": {"n": int(X.shape[0]), "d": int(X.shape[1]),
                  "classes": int(Y.shape[1])},
        "batch_size": batch_size, "nbatches": nbatches,
        "final_loss": {k: float(v[-1]) for k, v in curves.items()},
        "adaqn_events": [[it, info] for it, info in events],
        "adaqn_func_increased_iters": func_incr,
        "curves": {k: [round(float(x), 2) for x in v]
                   for k, v in curves.items()},
    }
    if source == "synthetic":
        _merge_write(args.out, out)               # legacy flat layout
    else:
        _merge_write(args.out, {f"{source}_run": out})
    print("final:", out["final_loss"])
    print("adaQN func_increased at iterations:", func_incr,
          "(reference notebook observed ~60/100/120 on real BibTeX)")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(9, 6))
        xs = np.arange(1, nbatches + 1) * batch_size
        for k in ("sgd", "rmsprop", "olbfgs", "adaqn"):
            ax.plot(xs, curves[k], label=k, linewidth=2)
        ax.set_xlabel("Accessed data points")
        ax.set_ylabel("Multinomial loss (test set)")
        ax.set_title(f"BibTeX-shaped logistic regression ({source} data)")
        ax.legend()
        fig.savefig(args.plot, dpi=120, bbox_inches="tight")
        print("plot:", args.plot)


if __name__ == "__main__":
    main()
