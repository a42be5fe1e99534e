"""Multi-host (2-process) distributed bundle adjustment over jax.distributed.

The reference has nothing to compare here (single process, SURVEY.md §5.8);
this validates the multi-host design: two OS processes, one global mesh,
landmark-sharded BA with the per-iteration psum of the reduced camera
system crossing the process boundary (Gloo CPU collectives stand in for
the card interconnect). Parity gate: the 2-process solve must match the single-process
solve bit-close.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

_WORKER = textwrap.dedent("""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address="127.0.0.1:%PORT%",
                           num_processes=2, process_id=int(sys.argv[1]))
import numpy as np
import jax.numpy as jnp
sys.path.insert(0, %REPO%)
from eorb_slam_tpu.geometry import camera, lie
from eorb_slam_tpu.optim import schur_ba
from eorb_slam_tpu.parallel import dist_ba, multihost

# deterministic problem, identical in both processes
K, M, P = 8, 256, 4
rng = np.random.default_rng(0)
cam = camera.make_pinhole(458.0, 457.0, 376.0, 240.0)
lm = np.concatenate([rng.uniform(-2, 2, (M, 2)),
                     rng.uniform(4, 8, (M, 1))], 1).astype(np.float32)
Ts = []
for k in range(K):
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [-0.25 * k, 0.0, 0.0]
    Ts.append(T)
Ts = np.stack(Ts)
obs_kf = rng.integers(0, K, (M, P)).astype(np.int32)
pc = np.einsum("mpij,mj->mpi", Ts[obs_kf][..., :3, :3], lm) + Ts[obs_kf][..., :3, 3]
uv = np.stack([458.0 * pc[..., 0] / pc[..., 2] + 376.0,
               457.0 * pc[..., 1] / pc[..., 2] + 240.0], -1).astype(np.float32)
uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
prob_np = schur_ba.BAProblem(
    cam_params=np.asarray(cam),
    kf_T=Ts,
    kf_fixed=np.asarray([True, True] + [False] * (K - 2)),
    kf_valid=np.ones(K, bool),
    lm_pos=(lm + rng.normal(0, 0.02, lm.shape)).astype(np.float32),
    lm_valid=np.ones(M, bool),
    obs_kf=obs_kf,
    obs_uv=uv,
    obs_inv_sigma=np.ones((M, P), np.float32),
    obs_valid=(pc[..., 2] > 0.1),
)

mesh = multihost.global_mesh()
assert len(mesh.devices.flat) == 2, mesh
p_glob = multihost.shard_problem_global(prob_np, mesh)
res = dist_ba.dist_bundle_adjust(p_glob, mesh, iters=6)
kf_T_dist = np.asarray(jax.device_get(res.kf_T.addressable_shards[0].data)) \
    if res.kf_T.is_fully_addressable is False else np.asarray(res.kf_T)
cost0, cost = float(res.cost0), float(res.cost)

# single-process reference on local arrays
import jax.tree_util as jtu
prob_local = jtu.tree_map(jnp.asarray, prob_np)
ref = schur_ba.bundle_adjust(prob_local, iters=6)
err = np.abs(kf_T_dist - np.asarray(ref.kf_T)).max()
print(f"proc {jax.process_index()} cost {cost0:.1f}->{cost:.1f} "
      f"parity {err:.2e}", flush=True)
assert cost < cost0
assert err < 1e-4, err
print("MH_OK", flush=True)
""")


@pytest.mark.slow
def test_two_process_dist_ba(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    port = 19741 + os.getpid() % 500
    script = _WORKER.replace("%PORT%", str(port)).replace("%REPO%", repr(repo))
    w = tmp_path / "worker.py"
    w.write_text(script)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("XLA_FLAGS", None)
    procs = [
        subprocess.Popen([sys.executable, str(w), str(i)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
        assert "MH_OK" in o, o[-2000:]


def test_comm_report_shapes():
    from eorb_slam_tpu.parallel import multihost

    r = multihost.comm_report(K=32, M=8192, P=8, n_devices=8)
    assert r["psum_bytes_per_iter"] == 4 * (32 * 32 * 36 + 32 * 6 + 4)
    assert r["flops_per_byte"] > 10  # compute-bound even across hosts
