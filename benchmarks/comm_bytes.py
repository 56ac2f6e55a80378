"""Collective-byte matrix over virtual-device counts.

For n_devices ∈ {8, 16, 32} (subprocess each — the virtual CPU device count
is fixed at backend init), lowers the sharded hc and nonuniform steps over
(c=1, p=n) and (c=2, p=n/2) meshes and records every collective payload
against COMM_MODEL.md's formulas:

    B_perm = B_psum payload = 2 · (C/c) · Hp · 4     (per stage)

The point being recorded: per-device traffic is O(C·Hp) — CONSTANT in both
the filter length P and the partition-shard count p — which is the premise
of the ≥80% scaling-efficiency model (COMM_MODEL.md 'Efficiency model').
Run:  python benchmarks/comm_bytes.py [--out COMM_BYTES.json]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys


def child(n_devices: int):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from bfir_tpu.core.spec import FilterSpec
    from bfir_tpu.parallel import mesh as M
    from bfir_tpu.parallel.sharded import ShardedEngine

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tests.test_parallel import _collective_bytes  # single source of truth

    results = []
    c = 8
    n = 128
    for c_shards in (1, 2):
        p_shards = n_devices // c_shards
        mesh = M.make_mesh(channel_shards=c_shards, partition_shards=p_shards)

        # uniform hc engine, two filter lengths (traffic must not change)
        for p_total in (max(8, p_shards), max(8, p_shards) * 4):
            spec = FilterSpec(block_length=n, n_partitions=p_total,
                              dtype="float32")
            eng = ShardedEngine(spec, c, mesh, local_impl="hc")
            state = jax.eval_shape(eng._init)
            state = jax.tree_util.tree_map(
                lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
                state, eng._state_shardings)
            coeffs = jax.ShapeDtypeStruct((p_total, 2, c, eng._hp), jnp.float32,
                                          sharding=eng._coeff_sharding)
            block = jax.ShapeDtypeStruct((c, n), jnp.float32,
                                         sharding=eng._block_sharding)
            txt = eng._step.lower(state, coeffs, block).compile().as_text()
            got = _collective_bytes(txt)
            model = 2 * (c // c_shards) * eng._hp * 4
            results.append(dict(
                impl="hc", n_devices=n_devices, mesh=[c_shards, p_shards],
                channels=c, partitions=p_total,
                perm_bytes=got["collective-permute"],
                psum_bytes=got["all-reduce"],
                allgather=got["all-gather"], model_bytes=model,
                ok=(got["all-gather"] == []
                    and got["collective-permute"] == [model]
                    and got["all-reduce"] == [model]),
            ))

        # nonuniform engine (head + cadenced tail)
        from bfir_tpu.core import nonuniform as NU

        nuspec = NU.NuSpec(block_length=n, ratio=2,
                           p_head=2 * 2 * p_shards, p_tail=p_shards,
                           dtype="float32")
        spec = FilterSpec(block_length=n, n_partitions=nuspec.max_taps // n,
                          dtype="float32")
        eng = ShardedEngine(spec, c, mesh, local_impl="nonuniform",
                            nuspec=nuspec)
        rng = np.random.default_rng(0)
        h = rng.standard_normal((c, nuspec.max_taps)).astype(np.float32) * 0.05
        st = jax.eval_shape(eng._init)
        st = jax.tree_util.tree_map(
            lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
            st, eng._state_shardings)
        co = eng.prepare_coeffs(h)
        co = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype, sharding=a.sharding),
            co)
        block = jax.ShapeDtypeStruct((c, n), jnp.float32,
                                     sharding=eng._block_sharding)
        txt = eng._step.lower(st, co, block).compile().as_text()
        got = _collective_bytes(txt)
        head = 2 * (c // c_shards) * eng._hp_h * 4
        tail = 2 * (c // c_shards) * eng._hp_t * 4
        results.append(dict(
            impl="nonuniform", n_devices=n_devices, mesh=[c_shards, p_shards],
            channels=c, partitions=spec.n_partitions,
            perm_bytes=got["collective-permute"],
            psum_bytes=got["all-reduce"],
            allgather=got["all-gather"],
            model_bytes=[head, tail],
            ok=(got["all-gather"] == []
                and sorted(got["collective-permute"]) == sorted([head, tail])
                and sorted(got["all-reduce"]) == sorted([head, tail])),
        ))

        # three-stage engine (outer head + inner head + far, r5): one
        # cp+ar pair per stage at its own cadence
        r1 = r2 = 2
        p_head3 = int(np.lcm(2 * r1, p_shards))
        p_head3i = int(np.lcm(2 * r2, p_shards))
        inner3 = NU.NuSpec(block_length=r1 * n, ratio=r2, p_head=p_head3i,
                           p_tail=p_shards, dtype="float32")
        spec3 = NU.Nu3Spec(block_length=n, ratio1=r1, p_head=p_head3,
                           inner=inner3)
        spec_f = FilterSpec(block_length=n,
                            n_partitions=spec3.max_taps // n,
                            dtype="float32")
        eng3 = ShardedEngine(spec_f, c, mesh, local_impl="nonuniform3",
                             nuspec=spec3)
        h3 = rng.standard_normal((c, spec3.max_taps)).astype(np.float32) * 0.05
        st = jax.eval_shape(eng3._init)
        st = jax.tree_util.tree_map(
            lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sh),
            st, eng3._state_shardings)
        co = eng3.prepare_coeffs(h3)
        co = jax.tree_util.tree_map(
            lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype,
                                           sharding=a.sharding), co)
        block = jax.ShapeDtypeStruct((c, n), jnp.float32,
                                     sharding=eng3._block_sharding)
        txt = eng3._step.lower(st, co, block).compile().as_text()
        got = _collective_bytes(txt)
        hp_n = -(-n // 128) * 128
        hp_m1 = -(-spec3.m1 // 128) * 128
        hp_m2 = -(-spec3.inner.m // 128) * 128
        sizes = [2 * (c // c_shards) * hp * 4 for hp in (hp_n, hp_m1, hp_m2)]
        results.append(dict(
            impl="nonuniform3", n_devices=n_devices,
            mesh=[c_shards, p_shards], channels=c,
            partitions=spec_f.n_partitions,
            perm_bytes=got["collective-permute"],
            psum_bytes=got["all-reduce"],
            allgather=got["all-gather"],
            model_bytes=sizes,
            ok=(got["all-gather"] == []
                and sorted(got["collective-permute"]) == sorted(sizes)
                and sorted(got["all-reduce"]) == sorted(sizes)),
        ))
    print(json.dumps(results))


def main():
    out = "COMM_BYTES.json"
    if "--out" in sys.argv:
        out = sys.argv[sys.argv.index("--out") + 1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    all_results = []
    for n in (8, 16, 32):
        env = dict(os.environ)
        env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n}"
        env["BFIR_COMM_CHILD"] = str(n)
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        r = subprocess.run([sys.executable, os.path.abspath(__file__)],
                           env=env, capture_output=True, text=True, timeout=900)
        if r.returncode:
            sys.stderr.write(r.stderr)
            raise SystemExit(f"child n={n} failed")
        all_results.extend(json.loads(r.stdout.strip().splitlines()[-1]))
    # the headline claim, machine-checked: per-device bytes constant in p
    # for fixed C/c (compare the same impl/c_shards across n_devices)
    const_ok = True
    for impl in ("hc", "nonuniform", "nonuniform3"):
        for cs in (1, 2):
            payloads = {tuple(sorted(r["perm_bytes"]))
                        for r in all_results
                        if r["impl"] == impl and r["mesh"][0] == cs}
            const_ok &= len(payloads) == 1
    summary = dict(results=all_results,
                   all_match_model=all(r["ok"] for r in all_results),
                   per_device_traffic_constant_in_p=const_ok)
    with open(os.path.join(root, out), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"all_match_model": summary["all_match_model"],
                      "per_device_traffic_constant_in_p": const_ok,
                      "rows": len(all_results), "out": out}))


if __name__ == "__main__":
    if os.environ.get("BFIR_COMM_CHILD"):
        child(int(os.environ["BFIR_COMM_CHILD"]))
    else:
        main()
