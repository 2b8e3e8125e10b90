"""2-process jax.distributed smoke test (round-1 verdict weak #8).

Exercises the actual multi-host process-group path (init_distributed ->
jax.distributed.initialize -> cross-process collectives) that the MUMPS/MPI
slot claims to replace — on CPU, two real OS processes, one device each.
"""
import os
import socket
import subprocess
import sys
import textwrap

import pytest

WORKER = textwrap.dedent("""
    import os, sys
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from respatpu.dist import init_distributed, make_mesh, P
    init_distributed(coordinator_address=sys.argv[1],
                     num_processes=2, process_id=int(sys.argv[2]))
    assert jax.device_count() == 2, jax.device_count()
    assert jax.local_device_count() == 1
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding
    mesh = make_mesh()
    # one shard per process; psum across the process boundary
    arr = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("row")),
        np.full((1, 4), float(jax.process_index()) + 1.0), (2, 4))
    from jax import shard_map
    f = jax.jit(shard_map(lambda x: jax.lax.psum(x, "row"),
                          mesh=mesh, in_specs=P("row"), out_specs=P("row")))
    out = f(arr)
    local = np.asarray(out.addressable_shards[0].data)
    assert np.allclose(local, 3.0), local   # 1 + 2 summed on every shard
    print("proc", jax.process_index(), "ok", flush=True)
""")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


@pytest.mark.slow
def test_two_process_psum(tmp_path):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    w = tmp_path / "worker.py"
    w.write_text(WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(__file__))
    procs = [subprocess.Popen([sys.executable, str(w), coord, str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, env=env, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, _ = p.communicate()
        outs.append((p.returncode, out))
    for rc, out in outs:
        assert rc == 0, out[-2000:]
    assert any("proc 0 ok" in o for _, o in outs)
    assert any("proc 1 ok" in o for _, o in outs)
