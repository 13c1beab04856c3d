"""Spectral clustering in numpy and scipy with scikit-learn's labels (a copy
of `sklearn.cluster.SpectralClustering(n_clusters, random_state=0,
assign_labels="discretize").fit_predict`, scikit-learn 1.9:
`cluster/_spectral.py`, `manifold/_spectral_embedding.py`,
`metrics/pairwise.py`).

A block's id keys its world frame, so the labels must be sklearn's own and
not a relabelling; this follows its arithmetic step by step:
  - the points in float64; the rbf affinity exp(-gamma |x - y|^2) with
    gamma = 1, the squared distances as -2 x.y + |x|^2 + |y|^2, clamped at
    0, with a zero diagonal, and symmetrised only if it is not symmetric
    within 1e-10;
  - the spectral embedding on sklearn's ARPACK branch: scipy's normalised
    Laplacian and its degree vector, the diagonal set to 1,
    `eigsh(L, k, sigma=-1e-5, which="LM", tol=0, v0)` with v0 uniform in
    [-1, 1), the eigenvectors divided by the degree vector, and each one's
    sign flipped so that its largest |entry| is positive;
  - `discretize` with 30 SVD restarts and n_iter_max 20.
One `np.random.RandomState(0)` is drawn first for v0, then by discretize.
"""
from __future__ import annotations

import numpy as np
from scipy.sparse import csc_array
from scipy.sparse.csgraph import laplacian as csgraph_laplacian
from scipy.sparse.linalg import eigsh


def rbf_affinity(x: np.ndarray, gamma: float = 1.0) -> np.ndarray:
    """sklearn's `rbf_kernel(x)` on float64 points."""
    norms = np.einsum("ij,ij->i", x, x)[:, None]
    d = -2 * (x @ x.T)
    d += norms
    d += norms.T
    np.maximum(d, 0, out=d)
    np.fill_diagonal(d, 0)
    d *= -gamma
    np.exp(d, out=d)
    if not np.allclose(d, d.T, atol=1e-10):
        d = 0.5 * (d + d.T)
    return d


def spectral_embedding(affinity: np.ndarray, n_components: int,
                       rng: np.random.RandomState) -> np.ndarray:
    """[n, n_components] embedding, sklearn's `_spectral_embedding(...,
    drop_first=False)` with the ARPACK solver."""
    lap, dd = csgraph_laplacian(affinity, normed=True, return_diag=True)
    lap.flat[::lap.shape[0] + 1] = 1
    v0 = rng.uniform(-1, 1, lap.shape[0])
    _, vectors = eigsh(lap, k=n_components, sigma=-1e-5, which="LM", tol=0, v0=v0)
    embedding = vectors.T[:n_components] / dd
    max_abs = np.argmax(np.abs(embedding), axis=1)
    embedding *= np.sign(embedding[range(embedding.shape[0]), max_abs])[:, None]
    return embedding[:n_components].T


def discretize(vectors: np.ndarray, rng: np.random.RandomState,
               max_svd_restarts: int = 30, n_iter_max: int = 20) -> np.ndarray:
    """The partition closest to the embedding (Yu and Shi 2003), sklearn's
    `discretize`."""
    eps = np.finfo(float).eps
    vectors = np.array(vectors, dtype=np.float64)
    n_samples, n_components = vectors.shape
    norm_ones = np.sqrt(n_samples)
    for i in range(n_components):
        vectors[:, i] = (vectors[:, i] / np.linalg.norm(vectors[:, i])) * norm_ones
        if vectors[0, i] != 0:
            vectors[:, i] = -1 * vectors[:, i] * np.sign(vectors[0, i])
    vectors = vectors / np.sqrt((vectors**2).sum(axis=1))[:, np.newaxis]

    svd_restarts = 0
    has_converged = False
    while svd_restarts < max_svd_restarts and not has_converged:
        rotation = np.zeros((n_components, n_components))
        rotation[:, 0] = vectors[rng.randint(n_samples), :].T
        c = np.zeros(n_samples)
        for j in range(1, n_components):
            c += np.abs(np.dot(vectors, rotation[:, j - 1]))
            rotation[:, j] = vectors[c.argmin(), :].T
        last_objective_value = 0.0
        n_iter = 0
        while not has_converged:
            n_iter += 1
            labels = np.dot(vectors, rotation).argmax(axis=1)
            vectors_discrete = csc_array(
                (np.ones(len(labels)), (np.arange(0, n_samples), labels)),
                shape=(n_samples, n_components))
            try:
                U, S, Vh = np.linalg.svd(vectors_discrete.T @ vectors)
            except np.linalg.LinAlgError:
                svd_restarts += 1
                break
            ncut_value = 2.0 * (n_samples - S.sum())
            if abs(ncut_value - last_objective_value) < eps or n_iter > n_iter_max:
                has_converged = True
            else:
                last_objective_value = ncut_value
                rotation = np.dot(Vh.T, U.T)
    if not has_converged:
        raise np.linalg.LinAlgError("SVD did not converge")
    return labels


def spectral_labels(points: np.ndarray, n_clusters: int, seed: int = 0) -> np.ndarray:
    """Cluster labels [n] of `points` [n, d], as sklearn's
    SpectralClustering(n_clusters, random_state=seed,
    assign_labels="discretize").fit_predict(points) gives them."""
    rng = np.random.RandomState(seed)
    affinity = rbf_affinity(np.asarray(points, np.float64))
    return discretize(spectral_embedding(affinity, n_clusters, rng), rng)
