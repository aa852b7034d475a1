"""Training-iteration predictors (paper Sec. IV-C3).

The paper predicts each job's total training iterations with a 100-tree
random-forest regression over (group id, user id) + historical job data,
retrained frequently; unseen jobs are predicted as 0 iterations so they are
treated as instantly complete in the virtual instance and scheduled ASAP.

scikit-learn is unavailable offline, so ``RandomForestRegressor`` below is a
from-scratch NumPy implementation: histogram-binned CART trees with MSE
splitting, bootstrap aggregation, and feature subsampling.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from .job import JobSpec

# --------------------------------------------------------------------------
# From-scratch random forest regression
# --------------------------------------------------------------------------


class _Tree:
    """Array-based CART regression tree on pre-binned uint16 features."""

    __slots__ = ("feature", "threshold", "left", "right", "value")

    def __init__(self) -> None:
        self.feature: List[int] = []
        self.threshold: List[int] = []  # bin index; go left if bin <= thr
        self.left: List[int] = []
        self.right: List[int] = []
        self.value: List[float] = []

    def _new_node(self) -> int:
        self.feature.append(-1)
        self.threshold.append(0)
        self.left.append(-1)
        self.right.append(-1)
        self.value.append(0.0)
        return len(self.feature) - 1

    def fit(
        self,
        Xb: np.ndarray,
        y: np.ndarray,
        n_bins: int,
        max_depth: int,
        min_samples_leaf: int,
        max_features: int,
        rng: np.random.Generator,
        leaf: str = "mean",
    ) -> None:
        n_features = Xb.shape[1]
        stack = [(self._new_node(), np.arange(len(y)), 0)]
        while stack:
            node, idx, depth = stack.pop()
            yn = y[idx]
            self.value[node] = float(
                np.median(yn) if leaf == "median" else yn.mean()
            )
            if (
                depth >= max_depth
                or len(idx) < 2 * min_samples_leaf
                or np.all(yn == yn[0])
            ):
                continue
            feats = rng.choice(
                n_features, size=min(max_features, n_features), replace=False
            )
            best = None  # (gain, feat, thr_bin)
            total_sum, total_cnt = yn.sum(), len(yn)
            base_sse_term = (total_sum * total_sum) / total_cnt
            for f in feats:
                xb = Xb[idx, f]
                cnt = np.bincount(xb, minlength=n_bins).astype(np.float64)
                sm = np.bincount(xb, weights=yn, minlength=n_bins)
                c_cnt = np.cumsum(cnt)[:-1]
                c_sum = np.cumsum(sm)[:-1]
                valid = (c_cnt >= min_samples_leaf) & (
                    (total_cnt - c_cnt) >= min_samples_leaf
                )
                if not valid.any():
                    continue
                with np.errstate(divide="ignore", invalid="ignore"):
                    gain = (
                        c_sum**2 / c_cnt
                        + (total_sum - c_sum) ** 2 / (total_cnt - c_cnt)
                        - base_sse_term
                    )
                gain = np.where(valid, gain, -np.inf)
                b = int(np.argmax(gain))
                if gain[b] > 1e-12 and (best is None or gain[b] > best[0]):
                    best = (float(gain[b]), int(f), b)
            if best is None:
                continue
            _, f, thr = best
            mask = Xb[idx, f] <= thr
            li, ri = idx[mask], idx[~mask]
            l_node, r_node = self._new_node(), self._new_node()
            self.feature[node] = f
            self.threshold[node] = thr
            self.left[node] = l_node
            self.right[node] = r_node
            stack.append((l_node, li, depth + 1))
            stack.append((r_node, ri, depth + 1))

    def predict(self, Xb: np.ndarray) -> np.ndarray:
        feature = np.asarray(self.feature)
        threshold = np.asarray(self.threshold)
        left = np.asarray(self.left)
        right = np.asarray(self.right)
        value = np.asarray(self.value)
        out = np.empty(len(Xb), dtype=np.float64)
        node_ids = np.zeros(len(Xb), dtype=np.int64)
        active = np.arange(len(Xb))
        while len(active):
            nodes = node_ids[active]
            leaf_mask = feature[nodes] < 0
            leaf_rows = active[leaf_mask]
            out[leaf_rows] = value[nodes[leaf_mask]]
            active = active[~leaf_mask]
            if not len(active):
                break
            nodes = node_ids[active]
            go_left = (
                Xb[active, feature[nodes]] <= threshold[nodes]
            )
            node_ids[active] = np.where(go_left, left[nodes], right[nodes])
        return out


class RandomForestRegressor:
    """Bootstrap-aggregated regression trees (MSE splits), NumPy only."""

    def __init__(
        self,
        n_estimators: int = 100,
        max_depth: int = 12,
        min_samples_leaf: int = 1,
        max_features: Optional[int] = None,
        n_bins: int = 256,
        max_samples: float = 1.0,
        seed: int = 0,
        leaf: str = "mean",  # "median": robust leaves (beyond-paper; exact
        #                       on constant recurrence under kill noise)
    ):
        self.n_estimators = n_estimators
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.n_bins = n_bins
        self.max_samples = max_samples
        self.seed = seed
        self.leaf = leaf
        self._trees: List[_Tree] = []
        self._bin_edges: List[np.ndarray] = []

    def _bin(self, X: np.ndarray) -> np.ndarray:
        Xb = np.empty(X.shape, dtype=np.int64)
        for f in range(X.shape[1]):
            Xb[:, f] = np.searchsorted(self._bin_edges[f], X[:, f], side="left")
        return Xb

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RandomForestRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        if X.ndim != 2 or len(X) != len(y) or len(y) == 0:
            raise ValueError("X must be (n, f) with matching non-empty y")
        self._bin_edges = []
        for f in range(X.shape[1]):
            qs = np.quantile(
                X[:, f], np.linspace(0, 1, self.n_bins), method="nearest"
            )
            self._bin_edges.append(np.unique(qs)[1:])  # internal boundaries
        Xb = self._bin(X)
        n_bins_eff = self.n_bins + 1
        rng = np.random.default_rng(self.seed)
        max_features = self.max_features or X.shape[1]
        n_sample = max(1, int(round(self.max_samples * len(y))))
        self._trees = []
        for _ in range(self.n_estimators):
            rows = rng.integers(0, len(y), size=n_sample)
            tree = _Tree()
            tree.fit(
                Xb[rows],
                y[rows],
                n_bins_eff,
                self.max_depth,
                self.min_samples_leaf,
                max_features,
                rng,
                leaf=self.leaf,
            )
            self._trees.append(tree)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        if not self._trees:
            raise RuntimeError("fit() before predict()")
        Xb = self._bin(np.asarray(X, dtype=np.float64))
        preds = np.stack([tree.predict(Xb) for tree in self._trees])
        if self.leaf == "median":
            return np.median(preds, axis=0)
        return preds.mean(axis=0)


# --------------------------------------------------------------------------
# Scheduler-facing predictors
# --------------------------------------------------------------------------


class IterationPredictor:
    """Online interface: observe completed jobs, predict iterations."""

    def observe(self, job: JobSpec, true_iters: int) -> None:
        raise NotImplementedError

    def predict(self, job: JobSpec) -> float:
        raise NotImplementedError


class PerfectPredictor(IterationPredictor):
    def observe(self, job: JobSpec, true_iters: int) -> None:
        pass

    def predict(self, job: JobSpec) -> float:
        return float(job.n_iters)


class _GroupStats:
    __slots__ = ("values", "n", "total", "stat_n", "stat_val")

    def __init__(self) -> None:
        self.values: Optional[List[float]] = None  # median only (O(obs))
        self.n = 0
        self.total = 0.0
        # statistic memo: recurring-group arrivals between observations
        # would otherwise recompute the same mean/median per prediction
        self.stat_n = -1
        self.stat_val = 0.0


class GroupStatPredictor(IterationPredictor):
    """Mean/median of the group's previously observed iteration counts.

    The mean statistic keeps only (count, running sum) per group — O(1)
    per group, so memory stays bounded by the group universe on
    million-job streams.  Iteration counts are integer-valued, so the
    running sum is exact (no drift vs ``np.mean``).  The median keeps
    the observation list (order statistics need it).
    """

    def __init__(self, statistic: str = "mean"):
        if statistic not in ("mean", "median"):
            raise ValueError(statistic)
        self.statistic = statistic
        self._groups: Dict[int, _GroupStats] = defaultdict(_GroupStats)

    def observe(self, job: JobSpec, true_iters: int) -> None:
        if job.group_id >= 0:
            st = self._groups[job.group_id]
            st.n += 1
            st.total += float(true_iters)
            if self.statistic == "median":
                if st.values is None:
                    st.values = []
                st.values.append(float(true_iters))

    def predict(self, job: JobSpec) -> float:
        st = self._groups.get(job.group_id)
        if job.group_id < 0 or st is None or st.n == 0:
            return 0.0  # unseen job -> treat as instantly complete
        if st.stat_n != st.n:
            if self.statistic == "mean":
                st.stat_val = st.total / st.n
            else:
                st.stat_val = float(np.median(st.values))
            st.stat_n = st.n
        return st.stat_val


class RandomForestPredictor(IterationPredictor):
    """Paper's predictor: RF regression over ids + group history features.

    Features per job: [group_id, user_id, group_count, group_mean,
    group_median, group_last].  Retrains every ``retrain_every``
    observations (the paper retrains hourly/daily; 80 s for 700 k jobs).

    ``max_history`` bounds the training window to the most recent N
    completions: with in-run online retraining (prediction_loop's
    ``OnlineForestModel``) each refit would otherwise grow linearly with
    the stream, and real cluster recurrence drifts (arXiv 2109.01313),
    so a sliding window keeps both cost bounded and the model fresh.
    """

    def __init__(
        self,
        n_estimators: int = 100,
        retrain_every: int = 1500,  # ~daily at MLaaS arrival rates
        seed: int = 0,
        max_depth: int = 16,
        n_bins: int = 1024,
        max_history: Optional[int] = None,
    ):
        self.retrain_every = retrain_every
        self.max_history = max_history
        self._rf = RandomForestRegressor(
            n_estimators=n_estimators,
            max_depth=max_depth,
            max_samples=0.6,
            seed=seed,
            leaf="median",
            n_bins=n_bins,  # group-id granularity (~#groups)
        )
        self._groups: Dict[int, List[float]] = defaultdict(list)
        self._X: List[List[float]] = []
        self._y: List[float] = []
        self._since_retrain = 0
        self._fitted = False

    def _features(self, job: JobSpec) -> List[float]:
        vals = self._groups.get(job.group_id, [])
        if vals:
            mean, med, last = (
                float(np.mean(vals)),
                float(np.median(vals)),
                vals[-1],
            )
        else:
            mean = med = last = 0.0
        return [
            float(job.group_id),
            float(job.user_id),
            float(len(vals)),
            mean,
            med,
            last,
        ]

    def observe(self, job: JobSpec, true_iters: int) -> None:
        # Record the training example with the features *as seen at
        # prediction time* (before appending this observation).
        self._X.append(self._features(job))
        self._y.append(float(true_iters))
        if job.group_id >= 0:
            self._groups[job.group_id].append(float(true_iters))
        if self.max_history is not None and len(self._y) > 2 * self.max_history:
            # amortized O(1): trim in bulk once the buffer doubles
            del self._X[: len(self._X) - self.max_history]
            del self._y[: len(self._y) - self.max_history]
        self._since_retrain += 1
        if self._since_retrain >= self.retrain_every and len(self._y) >= 32:
            self._rf.fit(np.array(self._X), np.array(self._y))
            self._fitted = True
            self._since_retrain = 0

    def warm_start(self) -> None:
        """Force a fit on everything observed so far (paper Sec. V-A.1-c:
        the predictor is trained on the first 80 % of the trace)."""
        if len(self._y) >= 32:
            self._rf.fit(np.array(self._X), np.array(self._y))
            self._fitted = True
            self._since_retrain = 0

    def predict(self, job: JobSpec) -> float:
        if job.group_id < 0 or job.group_id not in self._groups:
            return 0.0  # unseen -> instantly complete in the virtual machine
        if not self._fitted:
            vals = self._groups[job.group_id]
            return float(np.median(vals)) if vals else 0.0
        pred = float(self._rf.predict(np.array([self._features(job)]))[0])
        return max(pred, 0.0)


def make_predictor(kind: str, seed: int = 0, **kw) -> IterationPredictor:
    if kind == "perfect":
        return PerfectPredictor()
    if kind == "mean":
        return GroupStatPredictor("mean")
    if kind == "median":
        return GroupStatPredictor("median")
    if kind == "rf":
        return RandomForestPredictor(seed=seed, **kw)
    raise ValueError(f"unknown predictor kind {kind!r}")
