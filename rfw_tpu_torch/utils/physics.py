"""Minimal rigid-sphere impulse integrator.

Stands in for the external nphysics3d engine the reference's physics demo
couples to (examples/nphysics/src/main.rs:1-379: mechanical world stepped
per frame, body isometries copied into scene instance transforms). Scope:
spheres + a ground plane, gravity, impulses, sphere-sphere and
sphere-plane restitution — enough to drive per-frame TLAS rebuilds the way
the reference demo does. Vectorized numpy, no per-body loops.

Host copy of `rfw_tpu/utils/physics.py`: the same numpy code with its imports
rewritten to `rfw_tpu_torch`, so that it computes what the original
computes, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class SphereWorld:
    positions: np.ndarray  # (N,3)
    velocities: np.ndarray  # (N,3)
    radii: np.ndarray  # (N,)
    inv_mass: np.ndarray  # (N,) 0 = static
    gravity: np.ndarray = field(default_factory=lambda: np.array([0, -9.81, 0], np.float32))
    restitution: float = 0.6
    friction: float = 0.08
    ground_y: float = 0.0

    @staticmethod
    def new(n: int = 0) -> "SphereWorld":
        return SphereWorld(
            positions=np.zeros((n, 3), np.float32),
            velocities=np.zeros((n, 3), np.float32),
            radii=np.ones(n, np.float32),
            inv_mass=np.ones(n, np.float32),
        )

    def add_sphere(self, position, radius=0.5, velocity=(0, 0, 0), mass=1.0) -> int:
        self.positions = np.vstack([self.positions, np.asarray(position, np.float32)])
        self.velocities = np.vstack([self.velocities, np.asarray(velocity, np.float32)])
        self.radii = np.append(self.radii, np.float32(radius))
        self.inv_mass = np.append(
            self.inv_mass, np.float32(0.0 if mass <= 0 else 1.0 / mass)
        )
        return len(self.radii) - 1

    def apply_impulse(self, idx: int, impulse) -> None:
        self.velocities[idx] += np.asarray(impulse, np.float32) * self.inv_mass[idx]

    def apply_impulse_all(self, impulse) -> None:
        self.velocities += np.asarray(impulse, np.float32)[None] * self.inv_mass[:, None]

    def step(self, dt: float, substeps: int = 2) -> None:
        for _ in range(substeps):
            self._substep(dt / substeps)

    def _substep(self, dt: float) -> None:
        movable = self.inv_mass > 0
        self.velocities[movable] += self.gravity[None] * dt
        self.positions += self.velocities * dt

        # ground plane (with tangential friction damping on contact)
        pen = self.ground_y + self.radii - self.positions[:, 1]
        hit = (pen > 0) & movable
        self.positions[hit, 1] += pen[hit]
        vy = self.velocities[hit, 1]
        self.velocities[hit, 1] = np.where(vy < 0, -vy * self.restitution, vy)
        self.velocities[hit, 0] *= max(0.0, 1.0 - self.friction * dt * 60.0)
        self.velocities[hit, 2] *= max(0.0, 1.0 - self.friction * dt * 60.0)

        # sphere-sphere impulses (O(N^2) vectorized; fine for demo scale)
        n = len(self.radii)
        if n < 2:
            return
        delta = self.positions[:, None, :] - self.positions[None, :, :]
        dist = np.linalg.norm(delta, axis=-1)
        rsum = self.radii[:, None] + self.radii[None, :]
        iu = np.triu_indices(n, k=1)
        overlap = (rsum - dist)[iu]
        pairs = np.nonzero(overlap > 0)[0]
        for p in pairs:
            i, j = iu[0][p], iu[1][p]
            d = dist[i, j]
            nrm = delta[i, j] / (d if d > 1e-9 else 1.0)
            rel_v = float(np.dot(self.velocities[i] - self.velocities[j], nrm))
            im_i, im_j = self.inv_mass[i], self.inv_mass[j]
            denom = im_i + im_j
            if denom <= 0:
                continue
            # positional correction
            corr = nrm * (overlap[p] / denom)
            self.positions[i] += corr * im_i
            self.positions[j] -= corr * im_j
            if rel_v < 0:
                jimp = -(1.0 + self.restitution) * rel_v / denom
                self.velocities[i] += nrm * (jimp * im_i)
                self.velocities[j] -= nrm * (jimp * im_j)
