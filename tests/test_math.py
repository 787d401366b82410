"""Math substrate tests (modelled on raysect/core/math/tests)."""

import math

import numpy as np
import pytest

from source_tpu.core.math import (
    AffineMatrix3D,
    Normal3D,
    Point3D,
    Quaternion,
    Vector3D,
    rotate,
    rotate_basis,
    rotate_vector,
    rotate_x,
    rotate_y,
    rotate_z,
    translate,
    to_cylindrical,
    from_cylindrical,
    extract_rotation,
    extract_translation,
)


class TestVector3D:
    def test_basic_ops(self):
        a = Vector3D(1, 2, 3)
        b = Vector3D(4, 5, 6)
        assert (a + b) == Vector3D(5, 7, 9)
        assert (b - a) == Vector3D(3, 3, 3)
        assert (2 * a) == Vector3D(2, 4, 6)
        assert (a / 2) == Vector3D(0.5, 1, 1.5)
        assert a.dot(b) == 32
        assert a.cross(b) == Vector3D(-3, 6, -3)

    def test_length_normalise(self):
        v = Vector3D(3, 4, 0)
        assert v.length == 5
        n = v.normalise()
        assert abs(n.length - 1) < 1e-12
        with pytest.raises(ZeroDivisionError):
            Vector3D(0, 0, 0).normalise()

    def test_orthogonal(self):
        for v in [Vector3D(1, 0, 0), Vector3D(1, 2, 3), Vector3D(0, 0, -2)]:
            o = v.orthogonal()
            assert abs(v.dot(o)) < 1e-12
            assert abs(o.length - 1) < 1e-12

    def test_lerp(self):
        a = Vector3D(0, 0, 0)
        b = Vector3D(2, 4, 6)
        assert a.lerp(b, 0.5) == Vector3D(1, 2, 3)


class TestPoint3D:
    def test_ops(self):
        p = Point3D(1, 1, 1)
        q = Point3D(4, 5, 6)
        v = q - p
        assert isinstance(v, Vector3D)
        assert v == Vector3D(3, 4, 5)
        assert p.distance_to(q) == math.sqrt(50)
        assert p.vector_to(q) == Vector3D(3, 4, 5)
        assert (p + Vector3D(1, 0, 0)) == Point3D(2, 1, 1)


class TestTransforms:
    def test_translate(self):
        m = translate(1, 2, 3)
        assert Point3D(0, 0, 0).transform(m) == Point3D(1, 2, 3)
        # vectors ignore translation
        assert Vector3D(1, 0, 0).transform(m) == Vector3D(1, 0, 0)

    def test_rotate_x(self):
        m = rotate_x(90)
        p = Point3D(0, 1, 0).transform(m)
        assert abs(p.x) < 1e-12 and abs(p.y) < 1e-12 and abs(p.z - 1) < 1e-12

    def test_rotate_y(self):
        m = rotate_y(90)
        p = Point3D(0, 0, 1).transform(m)
        assert abs(p.x - 1) < 1e-12 and abs(p.z) < 1e-12

    def test_rotate_z(self):
        m = rotate_z(90)
        p = Point3D(1, 0, 0).transform(m)
        assert abs(p.y - 1) < 1e-12

    def test_rotate_vector_matches_axis_rotations(self):
        for angle in (17.0, 90.0, -45.0):
            ma = rotate_vector(angle, Vector3D(1, 0, 0))
            mb = rotate_x(angle)
            assert ma.is_close(mb)

    def test_rotate_basis(self):
        m = rotate_basis(Vector3D(1, 0, 0), Vector3D(0, 0, 1))
        expected = AffineMatrix3D(
            [[0, 0, 1, 0], [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1]]
        )
        assert m.is_close(expected)

    def test_inverse(self):
        m = translate(1, 2, 3) * rotate(30, 20, 10)
        ident = m * m.inverse()
        assert ident.is_identity(1e-9)

    def test_cylindrical_roundtrip(self):
        r, z, phi = to_cylindrical(Point3D(1, 1, 1))
        assert abs(r - math.sqrt(2)) < 1e-12
        assert abs(phi - 45) < 1e-12
        p = from_cylindrical(r, z, phi)
        assert abs(p.x - 1) < 1e-12 and abs(p.y - 1) < 1e-12

    def test_extract_roundtrip(self):
        m = translate(4, 5, 6) * rotate(20, 10, 5)
        yaw, pitch, roll = extract_rotation(m)
        assert abs(yaw - 20) < 1e-9
        assert abs(pitch - 10) < 1e-9
        assert abs(roll - 5) < 1e-9
        assert extract_translation(m) == (4, 5, 6)


class TestNormal3D:
    def test_inverse_transpose_transform(self):
        # a scaling transform must bend normals with the inverse transpose
        m = AffineMatrix3D([[2, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
        m_inv = m.inverse()
        # surface y=x scaled by x'=2x: normal (1,-1,0) -> (0.5,-1,0) direction
        n = Normal3D(1, -1, 0).transform(m_inv)
        assert abs(n.x - 0.5) < 1e-12
        assert abs(n.y + 1) < 1e-12


class TestQuaternion:
    def test_axis_angle_matrix_roundtrip(self):
        q = Quaternion.from_axis_angle(Vector3D(0, 0, 1), 90)
        m = q.as_matrix()
        assert m.is_close(rotate_z(90))
        q2 = Quaternion.from_matrix(rotate_z(90))
        # q and q2 equal up to sign
        s = 1.0 if q.s * q2.s >= 0 else -1.0
        assert abs(q.x - s * q2.x) < 1e-9
        assert abs(q.s - s * q2.s) < 1e-9

    def test_mul_compose(self):
        qa = Quaternion.from_axis_angle(Vector3D(1, 0, 0), 30)
        qb = Quaternion.from_axis_angle(Vector3D(1, 0, 0), 45)
        qc = qa * qb
        assert abs(qc.angle - 75) < 1e-9

    def test_inverse(self):
        q = Quaternion(0.3, -0.2, 0.5, 0.9)
        r = q * q.inverse()
        assert abs(r.s - 1) < 1e-12
        assert abs(r.x) < 1e-12


class TestBatchMath:
    def test_transform_point_vs_host(self):
        import jax.numpy as jnp

        from source_tpu.core.math import batch as vmath

        m = translate(1, 2, 3) * rotate(25, 10, 40)
        pts = np.random.RandomState(0).randn(32, 3)
        dev = vmath.transform_point(jnp.asarray(m.to_array()), jnp.asarray(pts, jnp.float32))
        host = np.array(
            [list(Point3D(*p).transform(m)) for p in pts]
        )
        np.testing.assert_allclose(np.asarray(dev), host, atol=1e-5)

    def test_make_frame_orthonormal(self):
        import jax.numpy as jnp

        from source_tpu.core.math import batch as vmath

        n = vmath.normalise(jnp.asarray(np.random.RandomState(1).randn(64, 3), jnp.float32))
        t, b, nn = vmath.make_frame(n)
        np.testing.assert_allclose(np.asarray(vmath.dot(t, b)), 0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(vmath.dot(t, nn)), 0, atol=1e-5)
        np.testing.assert_allclose(np.asarray(vmath.length(t)), 1, atol=1e-5)


class TestPolyroots:
    def test_quadratic(self):
        import jax.numpy as jnp

        from source_tpu.core.math.polyroots import solve_quadratic

        a = jnp.asarray([1.0, 1.0, 1.0, 2.0])
        b = jnp.asarray([-3.0, 2.0, 0.0, 0.0])
        c = jnp.asarray([2.0, 1.0, 1.0, -8.0])
        roots, valid = solve_quadratic(a, b, c)
        np.testing.assert_allclose(np.asarray(roots[0]), [1, 2], atol=1e-6)
        np.testing.assert_allclose(np.asarray(roots[1]), [-1, -1], atol=1e-6)
        assert not bool(valid[2, 0])  # x^2+1: no real roots
        np.testing.assert_allclose(np.asarray(roots[3]), [-2, 2], atol=1e-6)

    def test_cubic(self):
        import jax.numpy as jnp

        from source_tpu.core.math.polyroots import solve_cubic

        # (x-1)(x-2)(x-3) = x^3 -6x^2 +11x -6
        roots, valid = solve_cubic(
            jnp.asarray([1.0]), jnp.asarray([-6.0]), jnp.asarray([11.0]), jnp.asarray([-6.0])
        )
        np.testing.assert_allclose(np.asarray(roots[0]), [1, 2, 3], atol=1e-4)

    def test_quartic(self):
        import jax.numpy as jnp

        from source_tpu.core.math.polyroots import solve_quartic

        # (x^2-1)(x^2-4) = x^4 -5x^2 +4
        roots, valid = solve_quartic(
            jnp.asarray([1.0]),
            jnp.asarray([0.0]),
            jnp.asarray([-5.0]),
            jnp.asarray([0.0]),
            jnp.asarray([4.0]),
        )
        np.testing.assert_allclose(np.asarray(roots[0]), [-2, -1, 1, 2], atol=1e-4)

    def test_quartic_with_odd_terms(self):
        """A quartic whose depressed form keeps its linear term (q != 0),
        so the Ferrari factor constants z/2 +/- q/(2s) must pair with the
        right sign of s: (x+3)(x-0.5)(x-1)(x-2)."""
        import jax.numpy as jnp

        from source_tpu.core.math.polyroots import solve_quartic

        coeffs = np.poly([-3.0, 0.5, 1.0, 2.0])
        roots, valid = solve_quartic(*[jnp.asarray([c], jnp.float32)
                                       for c in coeffs])
        assert np.asarray(valid[0]).all()
        np.testing.assert_allclose(np.asarray(roots[0]), [-3, 0.5, 1, 2],
                                   atol=1e-4)


class TestStats:
    def test_statsarray_merge_matches_numpy(self):
        from source_tpu.core.math import StatsArray2D

        rng = np.random.RandomState(2)
        frame = StatsArray2D(4, 3)
        data = rng.randn(100, 4, 3)
        # fold in two chunks via merge_arrays
        for chunk in (data[:40], data[40:]):
            mean = chunk.mean(axis=0)
            m2 = ((chunk - mean) ** 2).sum(axis=0)
            frame.merge_arrays(mean, m2, np.full((4, 3), chunk.shape[0]))
        np.testing.assert_allclose(frame.mean, data.mean(axis=0), atol=1e-10)
        np.testing.assert_allclose(
            frame.variance, data.var(axis=0, ddof=1), atol=1e-10
        )

    def test_device_combine(self):
        import jax.numpy as jnp

        from source_tpu.core.math.statsarray import combine_stats, fold_samples, zeros_stats

        rng = np.random.RandomState(3)
        data = rng.randn(50, 8).astype(np.float32)
        s = zeros_stats((8,))
        for chunk in (data[:20], data[20:]):
            x = jnp.asarray(chunk)
            s = fold_samples(
                s,
                jnp.sum(x, axis=0),
                jnp.sum(x * x, axis=0),
                jnp.full((8,), x.shape[0], jnp.float32),
            )
        mean, m2, n = s
        np.testing.assert_allclose(np.asarray(mean), data.mean(axis=0), atol=1e-5)
        np.testing.assert_allclose(
            np.asarray(m2) / (np.asarray(n) - 1), data.var(axis=0, ddof=1), atol=1e-4
        )
