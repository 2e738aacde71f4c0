"""Kalman filter for box tracking (constant-velocity, 8-dim cxcyah state),
numpy. Copy of unicorn_tpu/tracker/kalman.py: ByteTrack uses initiate,
multi_predict and multi_update; DeepSORT and MOTDT (tracker/legacy.py) also
predict, project, update and gate with CHI2INV95.

Reference lineage: the DeepSORT filter (state [cx, cy, aspect, h, vcx, vcy,
va, vh], measurement-space projection, chi-square gating).
"""
from __future__ import annotations

import numpy as np

# 0.95-quantile of chi-square distribution, used for gating
CHI2INV95 = {1: 3.8415, 2: 5.9915, 3: 7.8147, 4: 9.4877,
             5: 11.070, 6: 12.592, 7: 14.067, 8: 15.507, 9: 16.919}


class KalmanFilter:
    def __init__(self):
        ndim, dt = 4, 1.0
        self._motion_mat = np.eye(2 * ndim)
        for i in range(ndim):
            self._motion_mat[i, ndim + i] = dt
        self._update_mat = np.eye(ndim, 2 * ndim)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def initiate(self, measurement):
        """measurement: (4,) [cx, cy, a, h] -> (mean (8,), cov (8,8))."""
        mean_pos = measurement
        mean_vel = np.zeros_like(mean_pos)
        mean = np.r_[mean_pos, mean_vel]
        h = measurement[3]
        std = [
            2 * self._std_weight_position * h,
            2 * self._std_weight_position * h,
            1e-2,
            2 * self._std_weight_position * h,
            10 * self._std_weight_velocity * h,
            10 * self._std_weight_velocity * h,
            1e-5,
            10 * self._std_weight_velocity * h,
        ]
        return mean, np.diag(np.square(std))

    def predict(self, mean, covariance):
        h = mean[3]
        std_pos = [self._std_weight_position * h] * 2 + [1e-2, self._std_weight_position * h]
        std_vel = [self._std_weight_velocity * h] * 2 + [1e-5, self._std_weight_velocity * h]
        motion_cov = np.diag(np.square(np.r_[std_pos, std_vel]))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def multi_predict(self, means, covariances):
        """Vectorized predict for all tracks: means (N,8), covs (N,8,8)."""
        if len(means) == 0:
            return means, covariances
        h = means[:, 3]
        std_pos = np.stack([self._std_weight_position * h,
                            self._std_weight_position * h,
                            np.full_like(h, 1e-2),
                            self._std_weight_position * h], axis=1)
        std_vel = np.stack([self._std_weight_velocity * h,
                            self._std_weight_velocity * h,
                            np.full_like(h, 1e-5),
                            self._std_weight_velocity * h], axis=1)
        sqr = np.square(np.concatenate([std_pos, std_vel], axis=1))
        motion_cov = np.stack([np.diag(s) for s in sqr])
        means = means @ self._motion_mat.T
        covariances = self._motion_mat @ covariances @ self._motion_mat.T + motion_cov
        return means, covariances

    def project(self, mean, covariance):
        h = mean[3]
        std = [self._std_weight_position * h, self._std_weight_position * h,
               1e-1, self._std_weight_position * h]
        innovation_cov = np.diag(np.square(std))
        mean_p = self._update_mat @ mean
        cov_p = self._update_mat @ covariance @ self._update_mat.T
        return mean_p, cov_p + innovation_cov

    def update(self, mean, covariance, measurement):
        projected_mean, projected_cov = self.project(mean, covariance)
        chol = np.linalg.cholesky(projected_cov)
        kalman_gain = np.linalg.solve(
            chol.T, np.linalg.solve(chol, (covariance @ self._update_mat.T).T)
        ).T
        innovation = measurement - projected_mean
        new_mean = mean + kalman_gain @ innovation
        new_cov = covariance - kalman_gain @ projected_cov @ kalman_gain.T
        return new_mean, new_cov

    def multi_update(self, means, covariances, measurements):
        """Vectorized update for N tracks at once.

        means (N,8), covariances (N,8,8), measurements (N,4) -> same shapes.
        The update matrix is eye(4,8), so the projection is the top-left
        4x4 block of the covariance and CH^T is its first four columns.
        """
        if len(means) == 0:
            return means, covariances
        h = means[:, 3]
        wp = self._std_weight_position
        std = np.stack([wp * h, wp * h, np.full_like(h, 1e-1), wp * h], axis=1)
        R = np.zeros((len(means), 4, 4))
        R[:, np.arange(4), np.arange(4)] = np.square(std)
        S = covariances[:, :4, :4] + R                       # (N,4,4)
        CHt = covariances[:, :, :4]                          # (N,8,4)
        # K = CHt S^-1  via batched solve of S X = CHt^T
        K = np.linalg.solve(S, CHt.transpose(0, 2, 1)).transpose(0, 2, 1)
        innovation = measurements - means[:, :4]             # (N,4)
        new_means = means + (K @ innovation[..., None])[..., 0]
        new_covs = covariances - K @ S @ K.transpose(0, 2, 1)
        return new_means, new_covs

    def gating_distance(self, mean, covariance, measurements,
                       only_position=False, metric="maha"):
        projected_mean, projected_cov = self.project(mean, covariance)
        if only_position:
            projected_mean = projected_mean[:2]
            projected_cov = projected_cov[:2, :2]
            measurements = measurements[:, :2]
        d = measurements - projected_mean
        if metric == "gaussian":
            return np.sum(d * d, axis=1)
        chol = np.linalg.cholesky(projected_cov)
        z = np.linalg.solve(chol, d.T)
        return np.sum(z * z, axis=0)
