"""ML-driven job-completion-time (JCT) predictor (paper Appendix G).

The paper buckets JCT into 10-minute intervals and trains a gradient
boosting model (GBM [20]) over job metadata (requested CPUs/GPUs, drives,
owner department, ...), reporting RMSE 1.61 buckets on a held-out split.
sklearn/LightGBM are not available offline, so this module implements a
compact gradient-boosted regression-tree ensemble on numpy: exact greedy
splits, L2 loss, shrinkage, subsample bagging (the paper also bags for
uncertainty estimation).
"""

from __future__ import annotations

import dataclasses

import numpy as np

BUCKET_SECONDS = 600.0  # 10-minute intervals (Appendix G)


# --------------------------------------------------------------------- trees
@dataclasses.dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: float = 0.0
    is_leaf: bool = True


class RegressionTree:
    """Depth-limited CART regression tree with exact greedy L2 splits."""

    def __init__(self, max_depth: int = 3, min_leaf: int = 8):
        self.max_depth = max_depth
        self.min_leaf = min_leaf
        self.nodes: list[_Node] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RegressionTree":
        self.nodes = []
        self._build(X, y, np.arange(len(y)), depth=0)
        return self

    def _build(self, X, y, idx, depth) -> int:
        node_id = len(self.nodes)
        node = _Node(value=float(np.mean(y[idx])))
        self.nodes.append(node)
        if depth >= self.max_depth or len(idx) < 2 * self.min_leaf:
            return node_id
        best = self._best_split(X, y, idx)
        if best is None:
            return node_id
        f, thr = best
        mask = X[idx, f] <= thr
        li, ri = idx[mask], idx[~mask]
        node.is_leaf = False
        node.feature, node.threshold = f, thr
        node.left = self._build(X, y, li, depth + 1)
        node.right = self._build(X, y, ri, depth + 1)
        return node_id

    def _best_split(self, X, y, idx):
        n = len(idx)
        base_sum, base_sq = y[idx].sum(), (y[idx] ** 2).sum()
        base_err = base_sq - base_sum**2 / n
        best_gain, best = 1e-12, None
        for f in range(X.shape[1]):
            order = idx[np.argsort(X[idx, f], kind="stable")]
            xs, ys = X[order, f], y[order]
            csum = np.cumsum(ys)
            csq = np.cumsum(ys**2)
            for i in range(self.min_leaf, n - self.min_leaf):
                if xs[i] == xs[i - 1]:
                    continue
                ls, lq = csum[i - 1], csq[i - 1]
                rs, rq = base_sum - ls, base_sq - lq
                err = (lq - ls**2 / i) + (rq - rs**2 / (n - i))
                gain = base_err - err
                if gain > best_gain:
                    best_gain = gain
                    best = (f, float((xs[i] + xs[i - 1]) / 2))
        return best

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = np.empty(len(X))
        for r in range(len(X)):
            i = 0
            while not self.nodes[i].is_leaf:
                nd = self.nodes[i]
                i = nd.left if X[r, nd.feature] <= nd.threshold else nd.right
            out[r] = self.nodes[i].value
        return out


# ----------------------------------------------------------------------- GBM
class GBMRegressor:
    """Gradient boosting with L2 loss, shrinkage and row subsampling."""

    def __init__(
        self,
        n_rounds: int = 60,
        learning_rate: float = 0.15,
        max_depth: int = 3,
        subsample: float = 0.8,
        min_leaf: int = 8,
        seed: int = 0,
    ):
        self.n_rounds = n_rounds
        self.lr = learning_rate
        self.max_depth = max_depth
        self.subsample = subsample
        self.min_leaf = min_leaf
        self.seed = seed
        self.base_: float = 0.0
        self.trees_: list[RegressionTree] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBMRegressor":
        rng = np.random.default_rng(self.seed)
        X = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float)
        self.base_ = float(np.mean(y))
        pred = np.full(len(y), self.base_)
        self.trees_ = []
        for _ in range(self.n_rounds):
            resid = y - pred
            if self.subsample < 1.0:
                sel = rng.random(len(y)) < self.subsample
                if sel.sum() < 4 * self.min_leaf:
                    sel = np.ones(len(y), dtype=bool)
            else:
                sel = np.ones(len(y), dtype=bool)
            tree = RegressionTree(self.max_depth, self.min_leaf).fit(X[sel], resid[sel])
            self.trees_.append(tree)
            pred += self.lr * tree.predict(X)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, dtype=float)
        pred = np.full(len(X), self.base_)
        for t in self.trees_:
            pred += self.lr * t.predict(X)
        return pred


# --------------------------------------------------------------- JCT wrapper
#: metadata feature order used by the predictor (paper Appendix G).
JOB_FEATURES = (
    "n_gpus",
    "n_cpus",
    "mem_gb",
    "n_drives",
    "department",     # categorical, integer-coded (trees split natively)
    "priority",
    "hour_of_day",
    "user_avg_jct",   # historical average per owner
)


class JCTPredictor:
    """Coarse-grained JCT forecaster: predicts the 10-minute bucket index."""

    def __init__(self, n_bags: int = 5, **gbm_kw):
        self.n_bags = n_bags
        self.gbm_kw = gbm_kw
        self.models_: list[GBMRegressor] = []

    @staticmethod
    def featurize(jobs: list[dict]) -> np.ndarray:
        return np.array(
            [[float(j.get(f, 0.0)) for f in JOB_FEATURES] for j in jobs]
        )

    @staticmethod
    def to_bucket(jct_seconds: np.ndarray) -> np.ndarray:
        return np.floor(np.asarray(jct_seconds) / BUCKET_SECONDS)

    def fit(self, jobs: list[dict], jct_seconds: np.ndarray) -> "JCTPredictor":
        X = self.featurize(jobs)
        y = self.to_bucket(jct_seconds)
        self.models_ = [
            GBMRegressor(seed=b, **self.gbm_kw).fit(X, y) for b in range(self.n_bags)
        ]
        return self

    def predict_bucket(self, jobs: list[dict]) -> np.ndarray:
        X = self.featurize(jobs)
        preds = np.stack([m.predict(X) for m in self.models_])
        return preds.mean(axis=0)

    def predict_seconds(self, jobs: list[dict]) -> np.ndarray:
        # Upper edge of the predicted bucket: conservative for reservations.
        return (np.maximum(self.predict_bucket(jobs), 0.0) + 1.0) * BUCKET_SECONDS

    def uncertainty(self, jobs: list[dict]) -> np.ndarray:
        X = self.featurize(jobs)
        preds = np.stack([m.predict(X) for m in self.models_])
        return preds.std(axis=0)


# ------------------------------------------------------------ synthetic trace
def synthetic_trace(n_jobs: int, seed: int = 0) -> tuple[list[dict], np.ndarray]:
    """Synthetic cluster trace with learnable JCT structure, used to
    reproduce the Appendix G experiment shape (RMSE in bucket units)."""
    rng = np.random.default_rng(seed)
    jobs, jct = [], []
    for _ in range(n_jobs):
        dept = int(rng.integers(0, 6))
        n_gpus = int(2 ** rng.integers(0, 9))  # 1..256
        n_cpus = n_gpus * int(rng.integers(4, 12))
        mem = n_gpus * float(rng.integers(32, 128))
        drives = int(rng.integers(0, 8))
        priority = int(rng.integers(0, 3))
        hour = int(rng.integers(0, 24))
        user_avg = float(rng.lognormal(mean=7.2 + 0.2 * dept, sigma=0.4))
        base = (
            600
            + 70.0 * np.log2(max(n_gpus, 1)) ** 2
            + 260.0 * dept
            + 0.45 * user_avg
            + 320.0 * drives * (dept % 2)
        )
        noise = rng.lognormal(mean=0.0, sigma=0.22)
        jct.append(base * noise)
        jobs.append(
            dict(
                n_gpus=n_gpus,
                n_cpus=n_cpus,
                mem_gb=mem,
                n_drives=drives,
                department=dept,
                priority=priority,
                hour_of_day=hour,
                user_avg_jct=user_avg,
            )
        )
    return jobs, np.array(jct)
