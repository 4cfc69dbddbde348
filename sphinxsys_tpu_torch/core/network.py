"""Tree networks: branching particle networks grown over a surface
(counterpart of sphinxsys_tpu/core/network.py; reference
ParticleGenerator<BaseParticles, Network>,
for_3D_build/particle_generator/particle_generator_network.cpp, and
TreeBody, shared/bodies/complex_bodies/tree_body.{h,cpp}).

A binary tree of branches grows over a Shape's surface: each tentative
segment end is pulled back onto the surface (x -= phi n), steered by the
branch's bifurcation angle in the local tangent plane and by a repulsive
"density gradient" away from the particles already placed, and rejected
when it comes within 5 segment lengths of a branch outside its family.

The growth is host-side setup, run once: numpy with a brute-force
nearest neighbour, the shape's distance and normal evaluated by torch on
the CPU in float64.  The output is flat arrays: positions, each
particle's branch, and the tree's adjacency as a padded (N, K) table that
the list-based dynamics take (the reference's TreeInnerRelation).

    from sphinxsys_tpu_torch.core.geometry import Ellipsoid
    net = generate_network(Ellipsoid((0, 0, 0), (0.7, 0.7, 1.25)),
                           (0.0, -0.699, 0.35), (0.0, -0.69, 0.25), 5,
                           segment_length=0.12, segments_per_branch=4)
    adj = net.adjacency(k_max=4)
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

TINY = 1.0e-12


@dataclasses.dataclass
class Branch:
    """TreeBody::Branch (tree_body.h): its particles and its place in the
    tree."""

    id: int
    parent: int
    particles: List[int]
    end_direction: np.ndarray
    children: List[int]
    is_terminated: bool = False


@dataclasses.dataclass
class TreeNetwork:
    positions: np.ndarray        # (N, d)
    branch_id: np.ndarray        # (N,)
    branches: List[Branch]
    segment_length: float

    @property
    def n_particles(self) -> int:
        return len(self.positions)

    def edges(self) -> np.ndarray:
        """(E, 2) edges: consecutive particles of a branch, and the
        junction from the parent branch's last particle to the child's
        first (TreeBody::buildLocationReference)."""
        out = []
        for b in self.branches:
            out.extend(zip(b.particles[:-1], b.particles[1:]))
            if b.parent >= 0 and b.particles:
                parent = self.branches[b.parent]
                if parent.particles:
                    out.append((parent.particles[-1], b.particles[0]))
        return np.asarray(out, np.int64).reshape(-1, 2)

    def adjacency(self, k_max: int = 4) -> np.ndarray:
        """The tree relation as a padded (N, K) table, sentinel N."""
        n = self.n_particles
        adj = np.full((n, k_max), n, np.int64)
        cnt = np.zeros(n, np.int64)
        for a, b in self.edges():
            for x, y in ((a, b), (b, a)):
                if cnt[x] >= k_max:
                    raise ValueError("k_max too small for tree adjacency")
                adj[x, cnt[x]] = y
                cnt[x] += 1
        return adj


class _Grower:
    def __init__(self, shape, segment_length: float, grad_factor: float,
                 angle: float, repulsivity: float, seed: int):
        self.shape = shape
        self.seg = segment_length
        self.grad_factor = grad_factor
        self.angle = angle
        self.repulsivity = repulsivity
        self.rng = np.random.default_rng(seed)
        self.pos: List[np.ndarray] = []
        self.branch_of: List[int] = []
        self.branches: List[Branch] = []

    # -- shape queries, float64 on the CPU ------------------------------
    @staticmethod
    def _point(p):
        return torch.as_tensor(np.asarray(p, np.float64))[None]

    def _sd(self, p):
        with torch.no_grad():
            return float(self.shape.signed_distance(self._point(p))[0])

    def _normal(self, p):
        n = self.shape.find_normal_direction(self._point(p))[0]
        n = n.detach().numpy().astype(np.float64)
        return n / (np.linalg.norm(n) + TINY)

    def _project(self, p):
        """createATentativeNewBranchPoint: the point pulled onto the
        surface."""
        return p - self._sd(p) * self._normal(p)

    # -- nearest neighbour over the placed particles --------------------
    def _nearest(self, p):
        arr = np.asarray(self.pos)
        d = np.linalg.norm(arr - p, axis=1)
        i = int(np.argmin(d))
        return i, arr[i], d[i]

    def _density_gradient(self, p):
        """getGradientFromNearestPoints (network_cpp:40-63): the central
        difference of the distance to the nearest particle, pointing away
        from crowded regions."""
        delta = self.grad_factor * self.seg
        grad = np.zeros(len(p))
        for i in range(len(p)):
            up, down = p.copy(), p.copy()
            up[i] -= delta
            down[i] += delta
            _, _, du = self._nearest(up)
            _, _, dd = self._nearest(down)
            grad[i] = (dd - du) / 2.0 * delta
        return grad

    # -- growth ----------------------------------------------------------
    def _add_particle(self, branch: Branch, p, end_dir):
        self.pos.append(np.asarray(p, np.float64))
        self.branch_of.append(branch.id)
        branch.particles.append(len(self.pos) - 1)
        branch.end_direction = end_dir

    def _is_collision(self, new_point, parent_id):
        """isCollision (network_cpp:76-102): the nearest placed particle
        is of a branch outside the family and closer than 5 segments."""
        i, _, d = self._nearest(new_point)
        family = {parent_id} | set(self.branches[parent_id].children)
        return (self.branch_of[i] not in family) and (d < 5.0 * self.seg)

    def grow_branch(self, parent_id: int, angle: float, repulsivity: float,
                    n_segments: int) -> bool:
        parent = self.branches[parent_id]
        init_point = np.asarray(self.pos[parent.particles[-1]])
        init_dir = parent.end_direction

        surf_n = self._normal(init_point)
        in_plane = -np.cross(init_dir, surf_n)
        grad = self._density_gradient(init_point)
        direction = np.cos(angle) * init_dir + np.sin(angle) * in_plane
        direction /= np.linalg.norm(direction) + TINY
        end_dir = repulsivity * grad + direction
        end_dir /= np.linalg.norm(end_dir) + TINY

        new_point = self._project(init_point + end_dir * self.seg)
        if self._is_collision(new_point, parent_id):
            return False

        branch = Branch(id=len(self.branches), parent=parent_id,
                        particles=[], end_direction=end_dir, children=[])
        self.branches.append(branch)
        parent.children.append(branch.id)
        self._add_particle(branch, new_point, end_dir)

        for _ in range(1, n_segments):
            surf_n = self._normal(new_point)
            grad = self._density_gradient(new_point)
            grad -= np.dot(grad, surf_n) * surf_n     # onto the surface
            direction = repulsivity * grad + end_dir
            direction /= np.linalg.norm(direction) + TINY
            end_dir = direction
            end_point = new_point
            new_point = self._project(end_point + end_dir * self.seg)
            if self._is_collision(new_point, parent_id):
                branch.is_terminated = True
                break
            if np.linalg.norm(new_point - end_point) < 0.5 * self.seg:
                branch.is_terminated = True
                break
            self._add_particle(branch, new_point, end_dir)
        return True


def generate_network(shape, starting_point, second_point, iterations: int,
                     grad_factor: float = 5.0, segment_length: float = 0.1,
                     segments_per_branch: int = 10, angle: float = 0.3,
                     repulsivity: float = 0.5, fascicles: bool = False,
                     fascicle_angles=(-1.25, 0.75),
                     fascicle_ratio: float = 2.0,
                     seed: int = 0) -> TreeNetwork:
    """ParticleGenerator<BaseParticles, Network>::prepareGeometricData
    (network_cpp:168-240): the root segment toward `second_point`, an
    optional pair of fascicles, then `iterations` generations of
    bifurcations at +-(angle + U(-0.5, 0.5) 0.05) with repulsive
    steering (numpy's generator from `seed`, as the JAX package's)."""
    start = np.asarray(starting_point, np.float64)
    second = np.asarray(second_point, np.float64)
    g = _Grower(shape, segment_length, grad_factor, angle, repulsivity, seed)

    root = Branch(id=0, parent=-1, particles=[], children=[],
                  end_direction=(second - start)
                  / (np.linalg.norm(second - start) + TINY))
    g.branches.append(root)
    g._add_particle(root, start, root.end_direction)

    to_grow: List[int] = []
    if g.grow_branch(0, 0.0, 0.0, segments_per_branch):
        to_grow.append(len(g.branches) - 1)

    if fascicles and to_grow:
        trunk = to_grow[0]
        to_grow = []
        for a in fascicle_angles:
            n_seg = int(fascicle_ratio * segments_per_branch)
            if g.grow_branch(trunk, a, 0.0, n_seg):
                to_grow.append(len(g.branches) - 1)

    for _ in range(iterations):
        nxt: List[int] = []
        g.rng.shuffle(to_grow)
        for bid in to_grow:
            a = angle + float(g.rng.uniform(-0.5, 0.5)) * 0.05
            for sgn in (1.0, -1.0):
                if g.grow_branch(bid, sgn * a, repulsivity,
                                 segments_per_branch) \
                        and not g.branches[-1].is_terminated:
                    nxt.append(len(g.branches) - 1)
        to_grow = nxt

    return TreeNetwork(positions=np.asarray(g.pos),
                       branch_id=np.asarray(g.branch_of, np.int64),
                       branches=g.branches, segment_length=segment_length)
