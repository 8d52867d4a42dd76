"""The classical model zoo, the counterpart of ``bbbp_tpu/ops/linear.py``:
the non-tree base models of the classification ensemble and the linear
meta-learners of the regression stack.

The torch estimators fit on ``device`` (``cuda`` unless the caller asks for
``cpu``), in f32 with TF32 off (``similarity.f32_matmul``), and return numpy
from ``predict``/``predict_proba``. ``RidgeCV``'s alpha choice,
``NonNegativeLinearRegression``, ``GaussianNB`` and ``BernoulliNB`` are
numpy in the JAX package and are copies here.

The iterative fits are written once, on a leading lane axis: ``x`` [K, S, d]
holds K row sets (folds) that T trials share, and the parameters are
[T, K, ...]. An estimator is the case T = K = 1; ``train/batched_search.py``
runs every (trial, fold) pair of a search in one call. The JAX package's
``lax.scan`` loops become Python loops over those tensors:

- ``logreg_newton``: Newton/IRLS, a batched Cholesky of [T, K, d+1, d+1];
- ``svc_adam``: squared hinge, full-batch Adam, lr 0.05;
- ``mlp_adam``: a ReLU MLP, full-batch Adam with the bias corrections folded
  into the learning rate; gradients by autograd.

Adam's bias corrections 1 − 0.9^t and 1 − 0.999^t are f32 powers of an f32
step count, as in the JAX package.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from bbbp_tpu_torch.ops.forest_train import resolve_device
from bbbp_tpu_torch.ops.similarity import f32_matmul

Params = List[Tuple[torch.Tensor, torch.Tensor]]


class _ParamsMixin:
    """sklearn-style get_params/set_params from __init__ kwargs (for the
    search module)."""

    _param_names: tuple = ()

    def get_params(self, deep: bool = True):
        return {k: getattr(self, k) for k in self._param_names}

    def set_params(self, **p):
        for k, v in p.items():
            setattr(self, k, v)
        return self


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32) if not isinstance(
        x, torch.Tensor) else x, dtype=torch.float32, device=device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


@contextlib.contextmanager
def _on(device):
    """f32 products on the estimator's device."""
    with f32_matmul():
        yield resolve_device(device)


# ---------------------------------------------------------------------------
# Lane arithmetic: x [K, S, d] shared by T trials, w [T, K, d]
# ---------------------------------------------------------------------------

def lane_dot(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """z[t, k, s] = x[k, s] · w[t, k]: one bmm over the K row sets, x not
    repeated for the trials. → [T, K, S]."""
    return torch.bmm(x, w.permute(1, 2, 0)).permute(2, 0, 1)


def lane_tdot(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """g[t, k] = x[k]ᵀ r[t, k] for r [T, K, S] → [T, K, d]."""
    return torch.bmm(x.transpose(1, 2), r.permute(1, 2, 0)).permute(2, 0, 1)


def adam_corrections(n_steps: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(1 − 0.9^t, 1 − 0.999^t) for t = 1 … n_steps, f32 powers of f32 t."""
    t = torch.arange(1, n_steps + 1, dtype=torch.float32, device=device)
    return (1 - torch.full_like(t, 0.9) ** t, 1 - torch.full_like(t, 0.999) ** t)


def with_bias(x: torch.Tensor) -> torch.Tensor:
    """[..., S, d] → [..., S, d + 1], a column of ones last."""
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def logreg_newton(xb: torch.Tensor, y: torch.Tensor, l2: torch.Tensor,
                  n_iter: int) -> torch.Tensor:
    """Newton/IRLS for an L2-penalised logistic regression
    (``_logreg_newton``, ``_logreg_fit_predict``). xb [K, S, D] with the
    bias column last (unpenalised), y [K, S], l2 [T] → w [T, K, D].

    The Hessians Σ_s p(1−p) x xᵀ of all lanes are one bmm against the rows'
    outer products [K, S, D²], shared by the trials."""
    n_sets, n_rows, width = xb.shape
    dev = xb.device
    reg = l2[:, None] * torch.cat([torch.ones(width - 1, device=dev),
                                   torch.zeros(1, device=dev)])     # [T, D]
    reg = reg[:, None, :]                                            # [T, 1, D]
    outer = (xb[..., :, None] * xb[..., None, :]).reshape(n_sets, n_rows, -1)
    ridge = torch.diag_embed(reg + 1e-6)                             # [T, 1, D, D]
    w = torch.zeros((l2.shape[0], n_sets, width), device=dev)
    for _ in range(n_iter):
        p = torch.sigmoid(lane_dot(xb, w))
        g = lane_tdot(xb, p - y) + reg * w
        s = torch.clamp(p * (1 - p), min=1e-6)
        hess = torch.bmm(s.transpose(0, 1), outer).transpose(0, 1).reshape(
            *w.shape, width) + ridge
        chol, _ = torch.linalg.cholesky_ex(hess)
        w = w - torch.cholesky_solve(g[..., None], chol)[..., 0]
    return w


def svc_adam(x: torch.Tensor, y_pm: torch.Tensor, c: torch.Tensor,
             n_steps: int) -> torch.Tensor:
    """Squared-hinge linear SVM by full-batch Adam (``_svm_train``,
    ``_svc_fit_predict``): loss ½|w|² + c Σ max(0, 1 − y z)², bias
    unpenalised. x [K, S, d], y_pm [K, S] in ±1, c [T] → w [T, K, d + 1]."""
    n_sets, _, d = x.shape
    dev = x.device
    w = torch.zeros((c.shape[0], n_sets, d + 1), device=dev)
    m, v = torch.zeros_like(w), torch.zeros_like(w)
    c1, c2 = adam_corrections(n_steps, dev)
    c = c[:, None, None]
    for t in range(n_steps):
        z = lane_dot(x, w[..., :-1]) + w[..., -1:]
        margin = torch.clamp(1.0 - y_pm * z, min=0.0)
        gz = -(c * (2.0 * margin)) * y_pm                  # d loss / dz
        g = torch.cat([lane_tdot(x, gz) + w[..., :-1],
                       gz.sum(-1, keepdim=True)], dim=-1)
        m = 0.9 * m + 0.1 * g
        v = 0.999 * v + 0.001 * g * g
        w = w - 0.05 * (m / c1[t]) / (torch.sqrt(v / c2[t]) + 1e-8)
    return w


def init_mlp(dims: Sequence[int], seed: int) -> Params:
    """He-normal weights, zero biases, on the CPU from a ``torch.Generator``
    seeded by ``seed`` (the JAX package draws from ``jax.random``: the
    tests start both sides from JAX's, through ``models/convert.py::
    mlp_from_jax``)."""
    gen = torch.Generator().manual_seed(int(seed))
    params = []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        scale = torch.sqrt(torch.tensor(2.0 / d_in, dtype=torch.float32))
        params.append((torch.randn((d_in, d_out), generator=gen) * scale,
                       torch.zeros(d_out)))
    return params


def mlp_lanes(x: torch.Tensor, params: Params) -> torch.Tensor:
    """x [K, S, d] shared by T trials, params [(w [T, K, i, o], b [T, K, o])]
    → the output unit's margin [T, K, S]. The first layer is one bmm over
    the K row sets, x not repeated for the trials."""
    (w1, b1), rest = params[0], params[1:]
    n_trials, n_sets, d, h = w1.shape
    a = torch.bmm(x, w1.permute(1, 2, 0, 3).reshape(n_sets, d, n_trials * h))
    a = a.view(n_sets, x.shape[1], n_trials, h).permute(2, 0, 1, 3) + b1[:, :, None]
    for w, b in rest:
        a = torch.relu(a) @ w + b[:, :, None]
    return a[..., 0]


def mlp_adam(x: torch.Tensor, y: torch.Tensor, params: Params,
             lr: torch.Tensor, l2: torch.Tensor, n_steps: int,
             classify: bool) -> Params:
    """Full-batch Adam over an MLP (``_mlp_train``, ``_mlp_fit_predict``):
    mean logistic (``classify``) or squared loss plus l2 Σ|W|², step t's
    learning rate lr·√(1 − 0.999^t)/(1 − 0.9^t). x [K, S, d], y [K, S],
    params on the lane axes [T, K, ...], lr and l2 [T]. Returns the trained
    parameters, detached."""
    dev = x.device
    params = [(w.detach().clone().requires_grad_(),
               b.detach().clone().requires_grad_()) for w, b in params]
    flat = [p for pair in params for p in pair]
    moments = [(torch.zeros_like(p), torch.zeros_like(p)) for p in flat]
    c1, c2 = adam_corrections(n_steps, dev)
    lr_t = lr[None, :] * torch.sqrt(c2)[:, None] / c1[:, None]        # [n, T]
    l2 = l2[:, None]
    for t in range(n_steps):
        z = mlp_lanes(x, params)
        if classify:
            data = torch.mean(torch.clamp(z, min=0) - z * y
                              + torch.log1p(torch.exp(-torch.abs(z))), dim=-1)
        else:
            data = torch.mean((z - y) ** 2, dim=-1)
        reg = sum(torch.sum(w ** 2, dim=(-2, -1)) for w, _ in params)
        grads = torch.autograd.grad((data + l2 * reg).sum(), flat)
        with torch.no_grad():
            for i, (p, g) in enumerate(zip(flat, grads)):
                m, v = moments[i]
                m = 0.9 * m + 0.1 * g
                v = 0.999 * v + 0.001 * g ** 2
                moments[i] = (m, v)
                step = lr_t[t].view(-1, *([1] * (p.dim() - 1)))
                p.sub_(step * m / (torch.sqrt(v) + 1e-8))
    return [(w.detach(), b.detach()) for w, b in params]


def lane_params(params: Params, n_trials: int = 1, n_sets: int = 1) -> Params:
    """One MLP's [(w, b)] → the lane layout [T, K, ...], every lane a copy."""
    return [(w.expand(n_trials, n_sets, *w.shape).contiguous(),
             b.expand(n_trials, n_sets, *b.shape).contiguous())
            for w, b in params]


# ---------------------------------------------------------------------------
# Linear / ridge regression (closed form)
# ---------------------------------------------------------------------------

class LinearRegression(_ParamsMixin):
    """OLS via regularized normal equations (ridge with alpha→0), solved by
    an f32 Cholesky."""

    _param_names = ("alpha", "fit_intercept")

    def __init__(self, alpha: float = 1e-6, fit_intercept: bool = True,
                 device="cuda"):
        self.alpha = alpha
        self.fit_intercept = fit_intercept
        self.device = device
        self.coef_: Optional[torch.Tensor] = None
        self.intercept_: float = 0.0

    def fit(self, x, y) -> "LinearRegression":
        with _on(self.device) as dev:
            x, y = _f32(x, dev), _f32(y, dev)
            if self.fit_intercept:
                xm, ym = x.mean(0), y.mean()
                xc, yc = x - xm, y - ym
            else:
                xm, ym = torch.zeros(x.shape[1], device=dev), torch.zeros((), device=dev)
                xc, yc = x, y
            a = xc.T @ xc + self.alpha * torch.eye(x.shape[1], device=dev)
            b = xc.T @ yc
            chol, _ = torch.linalg.cholesky_ex(a)
            self.coef_ = torch.cholesky_solve(b[:, None], chol)[:, 0]
            self.intercept_ = float(ym - xm @ self.coef_)
        return self

    def predict(self, x) -> np.ndarray:
        with f32_matmul():
            return _np(_f32(x, self.coef_.device) @ self.coef_ + self.intercept_)


class Ridge(LinearRegression):
    """Ridge(alpha=1.0), the B8 stacking meta-learner."""

    def __init__(self, alpha: float = 1.0, fit_intercept: bool = True,
                 device="cuda"):
        super().__init__(alpha=alpha, fit_intercept=fit_intercept, device=device)


class RidgeCV(LinearRegression):
    """Ridge with the alpha chosen by efficient leave-one-out CV (float64
    numpy, as in the JAX package), then refit by ``LinearRegression``.

    For each candidate alpha the LOO residuals come from the hat-matrix
    shortcut r_i = (y_i - yhat_i) / (1 - h_ii) via one eigendecomposition of
    the centered Gram — no refits."""

    _param_names = ("alphas", "fit_intercept")

    def __init__(self, alphas=(1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 100.0),
                 fit_intercept: bool = True, device="cuda"):
        super().__init__(alpha=1e-6, fit_intercept=fit_intercept, device=device)
        self.alphas = tuple(alphas)
        self.alpha_: Optional[float] = None

    def fit(self, x, y) -> "RidgeCV":
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        if self.fit_intercept:
            xm, ym = x.mean(0), y.mean()
            xc, yc = x - xm, y - ym
        else:
            xc, yc = x, y
        # eigendecompose X^T X once; h_ii(alpha) and residuals per alpha
        # follow from the rotated design u = Xc @ V
        g = xc.T @ xc
        evals, vecs = np.linalg.eigh(g)
        u = xc @ vecs                                   # [n, d]
        uty = u.T @ yc                                  # [d]
        best, best_err = self.alphas[0], np.inf
        for a in self.alphas:
            w_rot = uty / (evals + a)
            yhat = u @ w_rot
            h = np.einsum("nd,d,nd->n", u, 1.0 / (evals + a), u)
            denom = np.clip(1.0 - h, 1e-6, None)
            if self.fit_intercept:          # intercept adds 1/n leverage
                denom = np.clip(denom - 1.0 / len(yc), 1e-6, None)
            err = float(np.mean(((yc - yhat) / denom) ** 2))
            if err < best_err:
                best, best_err = a, err
        self.alpha_ = float(best)
        self.alpha = float(best)
        return super().fit(x, y)


class NonNegativeLinearRegression(_ParamsMixin):
    """Least squares with non-negative coefficients (+ free intercept) —
    classic stabilizer for stacking over correlated OOF legs (Breiman 1996):
    a weak or divergent leg gets weight 0 instead of a compensating negative
    weight. Solved by projected gradient with the exact Lipschitz step; the
    problem is [N, n_legs]-sized so this is microseconds."""

    _param_names = ("n_iter",)

    def __init__(self, n_iter: int = 2000):
        self.n_iter = n_iter
        self.coef_: Optional[np.ndarray] = None
        self.intercept_: float = 0.0

    def fit(self, x, y) -> "NonNegativeLinearRegression":
        x, y = np.asarray(x, np.float64), np.asarray(y, np.float64)
        xm, ym = x.mean(0), y.mean()
        xc, yc = x - xm, y - ym
        g = xc.T @ xc
        b = xc.T @ yc
        lip = float(np.linalg.eigvalsh(g)[-1]) + 1e-12
        w = np.maximum(np.linalg.solve(g + 1e-8 * np.eye(len(b)), b), 0.0)
        for _ in range(self.n_iter):
            w = np.maximum(w - (g @ w - b) / lip, 0.0)
        self.coef_ = w.astype(np.float32)
        self.intercept_ = float(ym - xm @ w)
        return self

    def predict(self, x) -> np.ndarray:
        return np.asarray(np.asarray(x, np.float32) @ self.coef_
                          + self.intercept_)


# ---------------------------------------------------------------------------
# Logistic regression and the linear SVM
# ---------------------------------------------------------------------------

class _LinearClassifier(_ParamsMixin):
    """Decision z = x·w[:-1] + w[-1] on the device of ``w_``."""

    w_: Optional[torch.Tensor] = None

    def decision_function(self, x) -> np.ndarray:
        with f32_matmul():
            x = _f32(x, self.w_.device)
            return _np(x @ self.w_[:-1] + self.w_[-1])

    def predict(self, x) -> np.ndarray:
        return (self.decision_function(x) > 0).astype(np.int32)


class LogisticRegression(_LinearClassifier):
    _param_names = ("C", "n_iter")

    def __init__(self, C: float = 1.0, n_iter: int = 25, device="cuda"):
        self.C = C
        self.n_iter = n_iter
        self.device = device

    def fit(self, x, y) -> "LogisticRegression":
        with _on(self.device) as dev:
            xb = with_bias(_f32(x, dev))[None]
            l2 = torch.full((1,), 1.0 / self.C, device=dev)
            self.w_ = logreg_newton(xb, _f32(y, dev)[None], l2, self.n_iter)[0, 0]
        return self

    def predict_proba(self, x) -> np.ndarray:
        p = 1 / (1 + np.exp(-self.decision_function(x)))
        return np.stack([1 - p, p], axis=1)


class LinearSVC(_LinearClassifier):
    """Squared-hinge linear SVM with Platt-scaled probabilities — replaces
    SVC(kernel='linear', probability=True) (reference:
    Models/model_opt_20250130.py:430)."""

    _param_names = ("C", "n_steps")

    def __init__(self, C: float = 1.0, n_steps: int = 400, device="cuda"):
        self.C = C
        self.n_steps = n_steps
        self.device = device
        self._platt: Optional[LogisticRegression] = None

    def fit(self, x, y) -> "LinearSVC":
        with _on(self.device) as dev:
            x = _f32(x, dev)
            y_pm = _f32(y, dev) * 2 - 1
            c = torch.full((1,), self.C / max(1, x.shape[0]), device=dev)
            self.w_ = svc_adam(x[None], y_pm[None], c, self.n_steps)[0, 0]
            z = self.decision_function(x).reshape(-1, 1)
        self._platt = LogisticRegression(C=10.0, device=self.device).fit(
            z, np.asarray(y))
        return self

    def predict_proba(self, x) -> np.ndarray:
        z = self.decision_function(x).reshape(-1, 1)
        return self._platt.predict_proba(z)


# ---------------------------------------------------------------------------
# Naive Bayes (numpy, copies of the JAX package's)
# ---------------------------------------------------------------------------

class GaussianNB(_ParamsMixin):
    def fit(self, x, y) -> "GaussianNB":
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.int32)
        self.classes_ = np.unique(y)
        self.theta_ = np.stack([x[y == c].mean(0) for c in self.classes_])
        self.var_ = np.stack([x[y == c].var(0) + 1e-6 for c in self.classes_])
        self.prior_ = np.array([(y == c).mean() for c in self.classes_])
        return self

    def _joint(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        ll = -0.5 * (
            np.log(2 * np.pi * self.var_[None]) +
            (x[:, None, :] - self.theta_[None]) ** 2 / self.var_[None]
        ).sum(-1)
        return ll + np.log(self.prior_)[None]

    def predict_proba(self, x) -> np.ndarray:
        j = self._joint(x)
        j = j - j.max(1, keepdims=True)
        p = np.exp(j)
        return p / p.sum(1, keepdims=True)

    def predict(self, x) -> np.ndarray:
        return self.classes_[self._joint(x).argmax(1)]


class BernoulliNB(_ParamsMixin):
    """sklearn-style BernoulliNB with binarize=0.0 (reference: Models/model.py:139)."""

    _param_names = ("alpha", "binarize")

    def __init__(self, alpha: float = 1.0, binarize: float = 0.0):
        self.alpha = alpha
        self.binarize = binarize

    def fit(self, x, y) -> "BernoulliNB":
        xb = (np.asarray(x, np.float32) > self.binarize).astype(np.float32)
        y = np.asarray(y, np.int32)
        self.classes_ = np.unique(y)
        counts = np.stack([xb[y == c].sum(0) for c in self.classes_])
        n_c = np.array([(y == c).sum() for c in self.classes_], dtype=np.float32)
        self.feat_logp_ = np.log((counts + self.alpha) / (n_c[:, None] + 2 * self.alpha))
        self.feat_lognp_ = np.log(1 - np.exp(self.feat_logp_))
        self.prior_ = np.log(n_c / n_c.sum())
        return self

    def _joint(self, x) -> np.ndarray:
        xb = (np.asarray(x, np.float32) > self.binarize).astype(np.float32)
        return xb @ self.feat_logp_.T + (1 - xb) @ self.feat_lognp_.T + self.prior_[None]

    def predict_proba(self, x) -> np.ndarray:
        j = self._joint(x)
        j = j - j.max(1, keepdims=True)
        p = np.exp(j)
        return p / p.sum(1, keepdims=True)

    def predict(self, x) -> np.ndarray:
        return self.classes_[self._joint(x).argmax(1)]


# ---------------------------------------------------------------------------
# k nearest neighbours
# ---------------------------------------------------------------------------

def sq_distances(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """|x|² − 2x·tᵀ + |t|², summed in that order, [..., Nx, Nt]."""
    return (torch.sum(x * x, -1, keepdim=True) - 2 * x @ t.transpose(-2, -1)
            + torch.sum(t * t, -1)[..., None, :])


def nearest(d: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest entries of each row of ``d``, ascending,
    the lower index first among equal values (``jax.lax.top_k``'s order)."""
    return torch.sort(d, dim=-1, stable=True).indices[..., :k]


class KNeighborsClassifier(_ParamsMixin):
    _param_names = ("n_neighbors",)

    def __init__(self, n_neighbors: int = 5, device="cuda"):
        self.n_neighbors = n_neighbors
        self.device = device

    def fit(self, x, y) -> "KNeighborsClassifier":
        dev = resolve_device(self.device)
        self._x = _f32(x, dev)
        self._y = torch.as_tensor(np.asarray(y, np.int32), device=dev)
        return self

    def _neighbor_labels(self, x) -> np.ndarray:
        with f32_matmul():
            d = sq_distances(_f32(x, self._x.device), self._x)
            return _np(self._y[nearest(d, self.n_neighbors)])        # [n, k]

    def predict_proba(self, x) -> np.ndarray:
        p1 = self._neighbor_labels(x).mean(1)
        return np.stack([1 - p1, p1], axis=1)

    def predict(self, x) -> np.ndarray:
        return (self.predict_proba(x)[:, 1] > 0.5).astype(np.int32)


class KNeighborsRegressor(KNeighborsClassifier):
    def fit(self, x, y):
        dev = resolve_device(self.device)
        self._x = _f32(x, dev)
        self._y = _f32(y, dev)
        return self

    def predict(self, x) -> np.ndarray:
        return self._neighbor_labels(x).mean(1)


# ---------------------------------------------------------------------------
# Small MLP classifier/regressor
# ---------------------------------------------------------------------------

class MLPClassifier(_ParamsMixin):
    """Small fully-batched MLP — replaces sklearn MLPClassifier
    (reference: Models/model_opt_20250130.py:444). ``params_`` is a list of
    (w [in, out], b [out]) on the fit's device."""

    _param_names = ("hidden", "n_steps", "seed", "lr", "l2")
    _classify = True

    def __init__(self, hidden=(100,), n_steps: int = 500, seed: int = 0,
                 lr: float = 1e-3, l2: float = 0.0, device="cuda"):
        self.hidden = tuple(hidden)
        self.n_steps = n_steps
        self.seed = seed
        self.lr = lr
        self.l2 = l2
        self.device = device

    def fit(self, x, y) -> "MLPClassifier":
        with _on(self.device) as dev:
            x = _f32(x, dev)
            dims = (x.shape[1],) + self.hidden + (1,)
            init = [(w.to(dev), b.to(dev)) for w, b in init_mlp(dims, self.seed)]
            out = mlp_adam(x[None], _f32(y, dev)[None], lane_params(init),
                           torch.full((1,), float(self.lr), device=dev),
                           torch.full((1,), float(self.l2), device=dev),
                           self.n_steps, self._classify)
            self.params_ = [(w[0, 0], b[0, 0]) for w, b in out]
        return self

    def decision_function(self, x) -> np.ndarray:
        with f32_matmul():
            x = _f32(x, self.params_[0][0].device)
            return _np(mlp_lanes(x[None], lane_params(self.params_))[0, 0])

    def predict_proba(self, x) -> np.ndarray:
        p = 1 / (1 + np.exp(-self.decision_function(x)))
        return np.stack([1 - p, p], axis=1)

    def predict(self, x) -> np.ndarray:
        return (self.decision_function(x) > 0).astype(np.int32)


class MLPRegressor(MLPClassifier):
    _classify = False

    def predict(self, x) -> np.ndarray:
        return self.decision_function(x)
