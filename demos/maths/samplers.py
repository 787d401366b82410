"""Maths showcase: solid-angle / surface / targeted samplers.

Counterpart of the reference's demos/maths/{triangle_sampler,
plot_targeted_sampler}.py — draw batches from each sampler family and
verify their statistical invariants (pdf normalisation, cosine weighting,
area uniformity) in closed form.

Run: JAX_PLATFORMS=cpu python demos/maths/samplers.py
"""

import math
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import jax
import numpy as np

from source_tpu.core import Point3D
from source_tpu.core.math import (
    ConeUniformSampler, HemisphereCosineSampler, SphereSampler,
    TargetedSphereSampler, TriangleSampler3D,
)


def main():
    n = 50_000
    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, 5)

    # sphere sampler: mean direction ~ 0, pdf = 1/4pi
    sph = SphereSampler()
    dirs = np.asarray(sph.sample(keys[0], n))
    pdf = float(np.asarray(sph.pdf(dirs))[0])
    print(f"SphereSampler:      |mean dir| = {np.linalg.norm(dirs.mean(0)):.4f} "
          f"(-> 0), pdf = {pdf:.5f} (theory {1 / (4 * math.pi):.5f})")

    # cosine hemisphere: E[cos theta] = 2/3
    hemi = HemisphereCosineSampler()
    dirs = np.asarray(hemi.sample(keys[1], n))
    print(f"HemisphereCosine:   E[cos] = {dirs[:, 2].mean():.4f} (theory 0.6667)")

    # cone sampler: all samples inside the cone
    cone = ConeUniformSampler(25.0)
    dirs = np.asarray(cone.sample(keys[2], n))
    cos_min = math.cos(math.radians(25.0))
    inside_cone = float((dirs[:, 2] >= cos_min - 1e-6).mean())
    print(f"ConeUniform(25deg): fraction inside cone = {inside_cone:.4f} (-> 1)")

    # triangle sampler: centroid of samples = triangle centroid
    tri = TriangleSampler3D(Point3D(0, 0, 0), Point3D(2, 0, 0), Point3D(0, 2, 0))
    pts = np.asarray(tri.sample(keys[3], n))
    print(f"TriangleSampler3D:  sample centroid = {pts.mean(0).round(3)} "
          f"(theory [0.667 0.667 0.])")

    # targeted sphere sampler: ~targeted_path_prob of samples hit the cone
    targ = TargetedSphereSampler([(Point3D(0, 0, 5), 0.5, 1.0)])
    dirs = np.asarray(targ.sample(keys[4], n))
    sin_max = 0.5 / 5.0
    cos_max = math.sqrt(1 - sin_max ** 2)
    aimed = float((np.sum(dirs * np.array([0, 0, 1.0]), axis=-1) >= cos_max - 1e-6).mean())
    print(f"TargetedSphere:     fraction aimed at target = {aimed:.4f} "
          f"(>= targeted_path_prob = {targ.targeted_path_prob})")

    assert inside_cone > 0.999
    assert aimed >= targ.targeted_path_prob - 0.02
    assert abs(dirs.shape[0] - n) == 0


if __name__ == "__main__":
    main()
