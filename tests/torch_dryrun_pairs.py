"""Shared runner of the dry-run comparison tests
(tests/test_torch_dryrun_{moe,recurrent,decode}.py on the tiny mesh, data 2
x model 4; test_torch_dryrun_multi*.py on tiny-multi, pod 2 x data 2 x
model 2; test_torch_dryrun_production.py on "single" and "multi"): the
same cells run by the JAX package's dry-run and by the port's, both at one
cut depth (one repetition of each layer group) or at full depth.

JAX runs in a subprocess of 8 host devices (DRYRUN_DEVICES=8), with
``repro.launch.dryrun.get_arch`` replaced by the cut config, and records
beside its cell the FLOPs of hlo_cost alone (its dots: the record's
FLOPs are the larger of that and XLA's cost_analysis, which on the CPU
backend also counts every bf16 operand's conversion to f32).  The port
runs in subprocesses that must not load jax.  Nothing of either package
is edited.
"""
import json
import os
import subprocess
import sys
import tempfile

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.dirname(SRC)

_CUT = (
    "import dataclasses, json, sys\n"
    "def _cut(get):\n"
    "    def arch(name):\n"
    "        cfg = get(name)\n"
    "        if not CUT:\n"
    "            return cfg\n"
    "        groups = tuple((pat, 1) for pat, _ in cfg.groups)\n"
    "        return dataclasses.replace(cfg, n_layers=sum(len(p) for p, _ in groups),\n"
    "                                   layer_groups=groups)\n"
    "    return arch\n"
)

_JAX = _CUT + (
    "import repro.launch.dryrun as D\n"
    "from repro.launch.hlo_cost import analyze_hlo\n"
    "D.get_arch = _cut(D.get_arch)\n"
    "dots = []\n"
    "_roofline = D.roofline_from_compiled\n"
    "def _recorded(compiled, n, mf):\n"
    "    dots.append(analyze_hlo(compiled.as_text()).flops)\n"
    "    return _roofline(compiled, n, mf)\n"
    "D.roofline_from_compiled = _recorded\n"
    "out = {}\n"
    "for arch, shape in CELLS:\n"
    "    dots.clear()\n"
    "    r = D.run_cell(arch, shape, MESH)\n"
    "    r.pop('traceback', None)\n"
    "    r['dot_flops'] = dots[0] if dots else None\n"
    "    out[arch + ':' + shape] = r\n"
    "print('RESULT', json.dumps(out))\n"
)

_PORT = _CUT + (
    "import repro_torch.launch.dryrun as D\n"
    "D.get_arch = _cut(D.get_arch)\n"
    "out = {}\n"
    "for arch, shape in CELLS:\n"
    "    r = D.run_cell(arch, shape, MESH)\n"
    "    r.pop('traceback', None)\n"
    "    out[arch + ':' + shape] = r\n"
    "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
    "             or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
    "print('LOADED', bad)\n"
    "print('RESULT', json.dumps(out))\n"
)


def _start(code: str, cells, env: dict, cut: bool, mesh: str) -> tuple:
    """The runner code in a subprocess, its output into files (several run at
    once: a full pipe would stall one while the others are read)."""
    head = f"CELLS = {[tuple(c) for c in cells]!r}\nCUT = {cut!r}\nMESH = {mesh!r}\n"
    out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+")
    proc = subprocess.Popen([sys.executable, "-c", head + code], stdout=out, stderr=err,
                            text=True, env=env, cwd=ROOT)
    return proc, out, err


def _result(started: tuple, timeout: float) -> tuple:
    proc, out, err = started
    with out, err:
        proc.wait(timeout=timeout)
        out.seek(0)
        err.seek(0)
        text = out.read()
        assert proc.returncode == 0, err.read()[-3000:]
    line = next(x for x in text.splitlines() if x.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), text


def start_pairs(jax_cells, port_groups, cut: bool = True, mesh: str = "tiny") -> list:
    """Start the JAX cells in one subprocess and each group of port cells
    in one of its own, all at once, on ``mesh``, at the cut depth (or at
    full depth with ``cut=False``); :func:`finish_pairs` collects them."""
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    jax_env = dict(env, DRYRUN_DEVICES=str(MESH_DEVICES[mesh]), JAX_PLATFORMS="cpu")
    started = [_start(_JAX, jax_cells, jax_env, cut, mesh)]
    return started + [_start(_PORT, group, env, cut, mesh) for group in port_groups]


def finish_pairs(started: list, timeout: float = 600):
    """(JAX's records, the port's records) of :func:`start_pairs`'
    subprocesses, each keyed "arch:shape"; every one left is killed."""
    try:
        jax, _ = _result(started[0], timeout)
        port = {}
        for one in started[1:]:
            res, out = _result(one, timeout)
            assert "LOADED []" in out, out
            port.update(res)
    finally:
        for proc, _, _ in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return jax, port


def run_pairs(jax_cells, port_groups, timeout: float = 600, cut: bool = True,
              mesh: str = "tiny"):
    """:func:`start_pairs` then :func:`finish_pairs`: returns (JAX's
    records, the port's records), each keyed "arch:shape"."""
    return finish_pairs(start_pairs(jax_cells, port_groups, cut, mesh), timeout)


def flops(rec) -> float:
    return rec["roofline"]["flops_per_device"]


def collective_bytes(rec) -> float:
    return rec["roofline"]["collective_bytes"]


#: each mesh's devices, and the split of its "batch" axes (("pod", "data"))
MESH_DEVICES = {"tiny": 8, "tiny-multi": 8, "single": 256, "multi": 512}
BATCH_SPLIT = {"tiny": 2, "tiny-multi": 4, "single": 16, "multi": 32}


def ratios(key: str, jax_rec: dict, port_rec: dict) -> dict:
    """Port / JAX of one cell: FLOPs per device against JAX's record and,
    for a prefill or decode cell, against hlo_cost's dots (at a global
    batch under the batch axes' split, long_500k's 1 sequence, one batch
    shard's share of them: JAX pads the batch to one row per batch shard
    and computes every product on each, where the port computes it once,
    split over the contraction); collective bytes per device."""
    from repro_torch.models import get_shape

    shape = get_shape(key.split(":")[1])
    split = BATCH_SPLIT[jax_rec["mesh"]]
    out = {"flops_vs_record": flops(port_rec) / flops(jax_rec),
           "collective": collective_bytes(port_rec) / collective_bytes(jax_rec)}
    if shape.mode != "train":
        copies = split if shape.global_batch < split else 1
        out["flops"] = flops(port_rec) / (jax_rec["dot_flops"] / copies)
        out["padded_copies"] = copies
    return out


def check_cell(key: str, jax_rec: dict, port_rec: dict, mesh_gates: bool = False) -> dict:
    """Hold one port cell to JAX's; returns its ratios.

    Every cell JAX records ok is ok in the port, with JAX's parameter and
    model FLOP counts.  A train cell counts more than 6ND per device (its
    model FLOPs over its devices: eager keeps no remat, JAX's scan does).  A prefill or decode cell's FLOPs per
    device are within [0.75, 1.25] of JAX's dots (see :func:`ratios`).  A
    decode cell's collective bytes per device are within [0.25, 4] of
    JAX's.  With ``mesh_gates`` (the three-axis and production meshes) a
    train cell also counts at most 1.25 times JAX's recorded FLOPs per
    device, and every cell moves at most 4 times JAX's collective bytes per
    device, any less allowed (DTensor contracts over an fsdp-split dim
    where XLA gathers the weight)."""
    assert jax_rec["status"] == "ok", (key, jax_rec.get("error"))
    assert port_rec["status"] == "ok", (key, port_rec.get("error"))
    assert port_rec["param_counts"] == jax_rec["param_counts"], key
    model_flops = port_rec["roofline"]["model_flops"]
    assert model_flops == jax_rec["roofline"]["model_flops"], key
    r = ratios(key, jax_rec, port_rec)
    if mesh_gates:
        assert r["collective"] <= 4.0, (key, r)
    if "flops" not in r:
        assert flops(port_rec) > model_flops / port_rec["n_devices"], key
        if mesh_gates:
            assert r["flops_vs_record"] <= 1.25, (key, r)
        return r
    assert 0.75 <= r["flops"] <= 1.25, (key, r)
    if port_rec["mode"] == "decode" and not mesh_gates:
        assert 0.25 <= r["collective"] <= 4.0, (key, r)
    return r


#: the comparison's cells: the four archs JAX's dry-run compiles beyond the
#: dense ones, every shape, and StableLM-2-1.6B's decode_32k
CELLS = [(a, s) for a in ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e", "rwkv6-3b",
                          "recurrentgemma-9b")
         for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
CELLS.append(("stablelm-1.6b", "decode_32k"))


def main(argv=None) -> None:
    """Print the port / JAX table of every cell (counts only, on this
    machine's CPU), at the cut depth or, with --full, at full depth, on the
    tiny mesh or another (--mesh single); --arch takes every shape of the
    archs it lists instead of the CELLS; --port-dir takes the port's
    records from a full-depth sweep's JSONs
    (``python -m repro_torch.launch.dryrun ... --out DIR``) instead:

        PYTHONPATH=src python tests/torch_dryrun_pairs.py [--full] [--mesh M]
            [--arch A,B] [--port-dir DIR]
    """
    import argparse
    import time

    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--mesh", default="tiny", choices=sorted(MESH_DEVICES))
    ap.add_argument("--arch")
    ap.add_argument("--port-dir")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    cells = CELLS if args.mesh.startswith("tiny") else CELLS[:-1]
    if args.arch:
        cells = [(a, s) for a in args.arch.split(",")
                 for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k")]
    groups = [] if args.port_dir else [
        [c for c in cells if c[0] == a] for a in dict.fromkeys(a for a, _ in cells)]
    full = args.full or bool(args.port_dir)
    jax, port = run_pairs(cells, groups, timeout=7200, cut=not full, mesh=args.mesh)
    if args.port_dir:
        for a, s in cells:
            with open(os.path.join(args.port_dir, f"{a}_{s}_{args.mesh}.json")) as f:
                port[f"{a}:{s}"] = json.load(f)
    print(f"mesh {args.mesh}, depth {'full' if full else 'cut'}; "
          f"{time.perf_counter() - t0:.1f} s")
    print("| cell | JAX | port | FLOPs port / JAX record | FLOPs port / JAX dots "
          "| collective bytes port / JAX |")
    print("|---|---|---|---|---|---|")
    for a, s in cells:
        key = f"{a}:{s}"
        j, p = jax[key], port[key]
        if j["status"] != "ok" or p["status"] != "ok":
            print(f"| {key} | {j['status']} | {p['status']} | | | |")
            continue
        r = ratios(key, j, p)
        fl = "(train)"
        if "flops" in r:
            fl = f"{r['flops']:.3f}"
            if r["padded_copies"] > 1:
                fl += f" (JAX's dots / {r['padded_copies']})"
        print(f"| {key} | ok | ok | {r['flops_vs_record']:.3f} | {fl} "
              f"| {r['collective']:.3f} |")


if __name__ == "__main__":
    main()
