"""Two real processes of the port's sharded sweep on the CPU, and the guard
on what the port imports.

``test_two_process_gloo`` mirrors ``tests/test_distributed.py:78-115``: two
OS processes start a ``torch.distributed`` process group with the gloo
backend from the ``HZT_*`` variables on a free local port
(``parallel.init_distributed``), build a (2, 2) mesh of CPU slots (two per
process: the tile axis spans the processes), run
``horizon_sweep_fused_sharded`` with a tilt ramp and its gradient, and
check the assembled angles and both gradients against the single-device
call, bit-equal.  The workers import no JAX.

``test_port_imports_no_jax``: in a fresh interpreter, importing the port,
its ``parallel`` package and every ``ops`` module loads neither ``jax``
nor ``horayzon_tpu``.

Cost on the CPU: about 10 s (two worker processes of about 5 s each, run
together, and one import check).
"""

import os
import socket
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys

import numpy as np
import torch

from horayzon_tpu_torch import parallel
from horayzon_tpu_torch.ops import fused_sweep

pid = int(sys.argv[1])
mesh = parallel.init_distributed(
    n_azim=2, devices=[torch.device("cpu")] * 2, backend="gloo")
import torch.distributed as dist
assert dist.get_world_size() == 2 and dist.get_rank() == pid
assert mesh.shape == {"tile": 2, "azim": 2}, mesh.shape
assert [t for t, _, _ in mesh.local_slots()] == [pid, pid]

# deterministic synthetic terrain (both processes build the same array)
rng = np.random.default_rng(3)
n = 96
yy, xx = np.mgrid[0:n, 0:n]
z = np.zeros((n, n))
for _ in range(8):
    cy, cx = rng.uniform(0, n), rng.uniform(0, n)
    sig = rng.uniform(4.0, 16.0)
    z += rng.uniform(50, 300) * np.exp(
        -(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sig ** 2)))
z = torch.from_numpy(z.astype(np.float32))
ramp = tuple(torch.from_numpy(rng.normal(0.0, 1e-4, (32, 32)).astype(
    np.float32)) for _ in range(2))
kw = dict(dx=25.0, dy=-25.0, offset=(32, 32), inner_shape=(32, 32),
          azim_num=4, dist_search=700.0, hori_acc=0.25)


def step(fn):
    zz = z.clone().requires_grad_(True)
    rr = tuple(r.clone().requires_grad_(True) for r in ramp)
    h = fn(zz, rr)
    torch.mean(h ** 2).backward()
    return h.detach(), zz.grad, rr[0].grad, rr[1].grad


got = step(lambda zz, rr: parallel.horizon_sweep_fused_sharded(
    mesh, zz, tilt_ramp=rr, **kw))
want = step(lambda zz, rr: fused_sweep.horizon_sweep_fused(
    zz, tilt_ramp=rr, **kw))
for name, a, b in zip(("hori", "dz", "dA", "dB"), got, want):
    assert torch.equal(a, b), (name, (a - b).abs().max().item())
assert float(got[1].abs().max()) > 0.0
assert "jax" not in sys.modules and "horayzon_tpu" not in sys.modules
dist.destroy_process_group()
print(f"proc {pid}: DISTRIBUTED-OK", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("HZT_COORDINATOR", "HZT_NUM_PROCESSES", "HZT_PROCESS_ID"):
        env.pop(k, None)
    return env


def test_two_process_gloo(tmp_path):
    worker = tmp_path / "dist_worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    procs = []
    for i in range(2):
        env = _env()
        env.update(HZT_COORDINATOR=f"127.0.0.1:{port}", HZT_NUM_PROCESSES="2",
                   HZT_PROCESS_ID=str(i), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, str(worker), str(i)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, env=env, text=True))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-30:])
        assert p.returncode == 0, f"proc {i} rc={p.returncode}\n{tail}"
        assert f"proc {i}: DISTRIBUTED-OK" in out, f"proc {i}\n{tail}"


_IMPORTS = r"""
import importlib
import pkgutil
import sys

import horayzon_tpu_torch

for m in pkgutil.walk_packages(horayzon_tpu_torch.__path__,
                               "horayzon_tpu_torch."):
    if not m.name.startswith("horayzon_tpu_torch.native._"):  # g++ builds
        importlib.import_module(m.name)
assert "horayzon_tpu_torch.utils.streaming" in sys.modules
assert "horayzon_tpu_torch.native.bvhbase" in sys.modules
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "horayzon_tpu", "PIL",
                                       "osgeo", "xarray", "shapely", "fiona"))
assert not loaded, loaded
print("IMPORTS-OK")
"""


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORTS], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and "IMPORTS-OK" in res.stdout, (
        res.stdout[-2000:] + res.stderr[-2000:])
