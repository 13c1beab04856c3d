"""k-means in numpy with scikit-learn's labels (a copy of the algorithm of
`sklearn.cluster.KMeans(n_init=10, random_state=0)`, scikit-learn 1.9,
`cluster/_kmeans.py` and `_k_means_lloyd.pyx`).

The camera clustering of multi-block scenes names each block by its
label, and that id keys `world_frame_transforms.json`: a block must get
the id sklearn gives it, not the same cluster under another number. So
this follows sklearn step by step:
  - the data centred on its mean, its squared row norms;
  - one `np.random.RandomState(seed)` drawn in sequence over the inits;
  - k-means++ with 2 + int(log k) local trials, distances in float64 on
    float32 data, as `_euclidean_distances` upcasts them;
  - Lloyd in the data's dtype: distances |c|^2 - 2 x.c, the first of equal
    minima, centres summed sample by sample in order, empty clusters
    relocated to the farthest samples, the strict-convergence stop and
    sklearn's tolerance (mean variance x 1e-4) on the squared centre shift;
  - the lowest inertia kept, unless it is the same clustering relabelled.

Every sum runs sample by sample in order, as sklearn sums at one OpenMP
thread. At more threads sklearn splits the inertia's sum (and, over 256
samples, the centres' sums) between threads and adds the parts in the
order the threads finish, so where two different clusterings tie in
inertia to the last bits (cameras evenly spaced on a ring), its own
labels vary with the thread count; the port's are those of one thread.
"""
from __future__ import annotations

import numpy as np

def _row_norms_sq(x: np.ndarray) -> np.ndarray:
    return np.einsum("ij,ij->i", x, x)


def _sq_distances(a: np.ndarray, b: np.ndarray, b_norms: np.ndarray) -> np.ndarray:
    """Squared distances [len(a), len(b)] as sklearn's `_euclidean_distances`
    (squared=True) computes them: float32 inputs upcast to float64, the
    result rounded back and clamped at 0."""
    if a.dtype == np.float32:
        a64, b64 = a.astype(np.float64), b.astype(np.float64)
        d = -2 * (a64 @ b64.T)
        d += _row_norms_sq(a64)[:, None]
        d += _row_norms_sq(b64)[None, :]
        d = d.astype(np.float32)
    else:
        d = -2 * (a @ b.T)
        d += _row_norms_sq(a)[:, None]
        d += b_norms[None, :]
    return np.maximum(d, 0, out=d)


def kmeans_plusplus(x: np.ndarray, k: int, x_norms: np.ndarray, weight: np.ndarray,
                    rs: np.random.RandomState) -> np.ndarray:
    """sklearn's `_kmeans_plusplus`: the k initial centres."""
    n = x.shape[0]
    centers = np.empty((k, x.shape[1]), dtype=x.dtype)
    trials = 2 + int(np.log(k))
    first = rs.choice(n, p=weight / weight.sum())
    centers[0] = x[first]
    closest = _sq_distances(centers[0, np.newaxis], x, x_norms)
    pot = closest @ weight
    for c in range(1, k):
        rand_vals = rs.uniform(size=trials) * pot
        ids = np.searchsorted(np.cumsum(weight * closest), rand_vals)
        np.clip(ids, None, closest.size - 1, out=ids)
        dist = _sq_distances(x[ids], x, x_norms)
        np.minimum(closest, dist, out=dist)
        pots = dist @ weight.reshape(-1, 1)
        best = np.argmin(pots)
        pot = pots[best]
        closest = dist[best]
        centers[c] = x[ids[best]]
    return centers


def _seq_sq_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Row-wise squared distance summed feature by feature in the dtype, as
    `_euclidean_dense_dense` sums it (groups of 4, then the rest)."""
    d = a.shape[1]
    out = np.zeros(a.shape[0], a.dtype)
    for j in range(0, d - d % 4, 4):
        diff = a[:, j:j + 4] - b[:, j:j + 4]
        sq = diff * diff
        out += ((sq[:, 0] + sq[:, 1]) + sq[:, 2]) + sq[:, 3]
    for j in range(d - d % 4, d):
        diff = a[:, j] - b[:, j]
        out += diff * diff
    return out


def _assign(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Lloyd's E-step: argmin over |c|^2 - 2 x.c, the first of equal minima."""
    dist = _row_norms_sq(centers)[None, :] + x @ (centers.T * x.dtype.type(-2.0))
    return np.argmin(dist, axis=1).astype(np.int32)


def _lloyd_iter(x, weight, centers, labels):
    """One Lloyd step: (labels, new centres, centre shifts)."""
    k, d = centers.shape
    labels[:] = _assign(x, centers)
    new = np.zeros((k, d), x.dtype)
    w_in = np.zeros(k, x.dtype)
    np.add.at(w_in, labels, weight)  # sample by sample, in order
    np.add.at(new, labels, x * weight[:, None])
    empty = np.flatnonzero(w_in == 0)
    if empty.size:  # _relocate_empty_clusters_dense
        far_d = ((x - centers[labels]) ** 2).sum(axis=1)
        far = np.argpartition(far_d, -empty.size)[:-empty.size - 1:-1]
        if np.max(far_d) != 0:
            for new_id, i in zip(empty, far):
                old_id = labels[i]
                new[old_id] -= x[i] * weight[i]
                new[new_id] = x[i] * weight[i]
                w_in[new_id] = weight[i]
                w_in[old_id] -= weight[i]
    biggest = np.argmax(w_in)
    for j in range(k):  # _average_centers
        if w_in[j] > 0:
            new[j] *= x.dtype.type(1.0 / float(w_in[j]))
        else:
            new[j] = new[biggest]
    shift = np.sqrt(_seq_sq_dist(new, centers).astype(np.float64)).astype(x.dtype)
    return new, shift


def kmeans_single_lloyd(x, weight, centers, tol, max_iter: int = 300):
    """sklearn's `_kmeans_single_lloyd`: (labels, inertia)."""
    labels = np.full(x.shape[0], -1, np.int32)
    labels_old = labels.copy()
    strict = False
    for _ in range(max_iter):
        centers_new, shift = _lloyd_iter(x, weight, centers, labels)
        centers = centers_new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old[:] = labels
    if not strict:
        labels = _assign(x, centers)
    per_sample = _seq_sq_dist(x, centers[labels]) * weight
    inertia = x.dtype.type(0)
    for v in per_sample:  # sequential, in the dtype
        inertia = inertia + v
    return labels, inertia


def _same_clustering(a: np.ndarray, b: np.ndarray, k: int) -> bool:
    mapping = np.full(k, -1, np.int32)
    for la, lb in zip(a, b):
        if mapping[la] == -1:
            mapping[la] = lb
        elif mapping[la] != lb:
            return False
    return True


def kmeans_labels(points: np.ndarray, n_clusters: int, n_init: int = 10,
                  random_state: int = 0, tol: float = 1e-4,
                  max_iter: int = 300) -> np.ndarray:
    """`KMeans(n_clusters, n_init=n_init, random_state=random_state)
    .fit_predict(points)`: int32 labels [N]."""
    x = np.array(points, order="C", copy=True)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    if x.shape[0] < n_clusters:
        raise ValueError(f"n_samples={x.shape[0]} should be >= n_clusters={n_clusters}.")
    tol = np.mean(np.var(x, axis=0)) * tol  # _tolerance
    x -= x.mean(axis=0)
    x_norms = _row_norms_sq(x)
    weight = np.ones(x.shape[0], x.dtype)
    rs = np.random.RandomState(random_state)
    best_labels, best_inertia = None, None
    for _ in range(n_init):
        centers = kmeans_plusplus(x, n_clusters, x_norms, weight, rs)
        labels, inertia = kmeans_single_lloyd(x, weight, centers, tol, max_iter)
        if best_inertia is None or (inertia < best_inertia and not _same_clustering(
                labels, best_labels, n_clusters)):
            best_labels, best_inertia = labels, inertia
    return best_labels
