"""Hold this checkout's kernels to another checkout's (the parent) on one
card: the nvcc build of each, both started together (so that both meet the
same machine: one build after the other read 4% faster in one call and 23%
slower in the next), with every function's ptxas spill line; then the
single-type f16 keys of chip_smoke.py's four f16 phases (the (a) keys and
the (b) probes of phase_f16, phase_f16_transformer, phase_f16_conv and
phase_f16_attention) run by both checkouts' kernels on the same inputs,
their outputs compared bit for bit, and each timed from CUDA graphs in
turns (parent, this, this, parent; three rounds, the median ratio kept)
in one process.

    python scripts/port_mixed_compare.py --parent PATH [--out FILE]

PATH is a checkout of the other commit (for example unpacked with git
archive into a directory .gitignore lists). Its package is imported under
another name beside this one, and built with -fno-gnu-unique so that the
two libraries share no inline static (a GNU unique symbol is bound once for
every library that defines it). --out writes the results as JSON. Needs an
NVIDIA card; prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import re
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def load_as(name: str, path: Path):
    """The package at `path` imported under `name` (its imports are
    relative, so it runs beside this checkout's tpp_mlir_tpu_torch)."""
    spec = importlib.util.spec_from_file_location(
        name, path / "__init__.py", submodule_search_locations=[str(path)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def spills(log: str) -> dict:
    """{function: (stack frame, spill stores, spill loads) bytes} of a
    build's ptxas -v log, with the anonymous-namespace hash (which follows
    the source's contents) taken out of the name."""
    out, fn = {}, ""
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = re.sub(r"_GLOBAL__N__[0-9a-f]+_(\d+_\w+?_cu)_[0-9a-f]+",
                        r"_GLOBAL__N__\1", line.split("for", 1)[1].strip())
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            out[fn] = tuple(map(int, m.groups()))
    return out


def kernel_of(pkg: str, key, forced):
    """chip_smoke.f16_probe_kernel's choice of kernel, from the package
    named pkg (its own key classes)."""
    k = importlib.import_module(f"{pkg}.xsmm.kernels")
    flags = importlib.import_module(f"{pkg}.xsmm.flags")
    key = getattr(flags, type(key).__name__)(**dataclasses.asdict(key))
    if not forced:
        return k.build_kernel(key)
    if isinstance(key, flags.LayerNormKey):
        return k.build_layer_norm(key, forced)
    if isinstance(key, (flags.ConvNhwcKey, flags.ConvBrgemmKey)):
        return k.build_conv(key, forced)
    if isinstance(key, (flags.GroupedGemmKey, flags.GroupedWgradKey)):
        return k.build_grouped_gemm(key, forced)
    if isinstance(key, flags.Int8GemmKey):
        return k.build_int8(key, forced)
    return k.build_warm(key, forced)


def cases(g):
    """(label, key, forced, args, kwargs) of the four f16 phases' (a) keys
    and (b) probes, each with the inputs its phase makes."""
    import torch

    from tpp_mlir_tpu_torch.xsmm import FlashTrainBwdKey, reference_kernel
    out = []
    for label, key, _ in cs._f16_kernel_cases():
        out.append((f"f16 {label}", key, None, cs._f16_inputs(key, g), {}))
    for label, key, forced in cs._f16_gemm_probes():
        out.append((f"f16 probe {label}", key, forced,
                    cs.f16_probe(key)[0], {}))
    for label, key, forced in cs._f16t_kernel_cases():
        out.append((f"f16t {label}", key, forced, cs._f16t_inputs(key, g),
                    {}))
    for label, key, forced in cs._f16_transformer_probes():
        out.append((f"f16t probe {label}", key, forced,
                    cs.f16_probe(key)[0], {}))
    for label, key, forced in cs._f16c_kernel_cases():
        out.append((f"f16c {label}", key, forced, cs._f16c_inputs(key, g),
                    {}))
    for label, key, forced in cs._f16_conv_probes():
        out.append((f"f16c probe {label}", key, forced,
                    cs.f16_probe(key)[0], {}))
    for label, key, _ in cs._f16a_decode_cases():
        out.append((f"f16a {label}", key, None,
                    cs._decode_attn_inputs(key, g), {}))
    for label, key, _ in cs._f16a_train_cases():
        q, k, v, do = cs._flash_train_inputs(key, g)
        out.append((f"f16a fwd {label}", key, None, (q, k, v), {}))
        po, plse2 = reference_kernel(key)(q, k, v)
        bkey = FlashTrainBwdKey(**dataclasses.asdict(key))
        out.append((f"f16a bwd {label}", bkey, None,
                    (q, k, v, do, plse2, cs._flash_delta(do, po)), {}))
    for label, key, probe in cs._f16_attention_probes():
        args, kw = cs.f16_attention_probe(key, probe)[:2]
        out.append((f"f16a probe {label}", key, None, args, kw))
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--out", type=Path)
    opts = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("port_mixed_compare: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    load_as("tpp_parent", opts.parent.resolve() / "tpp_mlir_tpu_torch")
    builds = {name: importlib.import_module(f"{pkg}.xsmm.build") for
              name, pkg in (("parent", "tpp_parent"),
                            ("this", "tpp_mlir_tpu_torch"))}
    builds["parent"].NVCC_FLAGS = (*builds["parent"].NVCC_FLAGS,
                                   "-Xcompiler", "-fno-gnu-unique")
    result = {"card": smi.stdout.strip(), "build": {}, "keys": []}
    infos, logs = {}, {}
    threads = [threading.Thread(target=lambda n=n, m=m: infos.__setitem__(
        n, m.build())) for n, m in builds.items()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for name, mod in builds.items():
        info = infos[name]
        mod.library()
        logs[name] = spills(info.log)
        result["build"][name] = {"seconds": info.seconds,
                                 "compiled": info.compiled,
                                 "sources": info.sources}
        print(f"build {name}: {info.seconds:.2f} s "
              f"({'compiled' if info.compiled else 'cached'}); " + ", ".join(
                  f"{s} {t:.1f} s" for s, t in sorted(
                      (info.sources or {}).items(), key=lambda kv: -kv[1])),
              flush=True)
    new = []
    for fn in sorted(set(logs["parent"]) | set(logs["this"])):
        p, t = logs["parent"].get(fn), logs["this"].get(fn)
        if (p and p[1]) or (t and t[1]):
            print(f"spill {fn[:150]}: parent {p}, this {t}", flush=True)
        if t and t[1] and (p is None or t[1] > p[1]):
            new.append(fn)
    result["spills"] = {n: {"parent": logs["parent"].get(n),
                            "this": logs["this"].get(n)}
                        for n in set(logs["parent"]) | set(logs["this"])
                        if any(v and v[1] for v in (logs["parent"].get(n),
                                                    logs["this"].get(n)))}
    result["new_spills"] = new
    print(f"functions spilling more than in the parent (or only here): "
          f"{len(new)}: {new}", flush=True)
    g = torch.Generator(device="cuda").manual_seed(26)
    unequal, t0 = [], time.perf_counter()
    for label, key, forced, args, kw in cases(g):
        mine, theirs = cs.f16_probe_kernel(key, forced), \
            kernel_of("tpp_parent", key, forced)

        def run(kern):
            return cs._outputs(kern(*args, **kw))
        a, b = run(theirs), run(mine)
        torch.cuda.synchronize()
        equal = len(a) == len(b) and all(torch.equal(x, y)
                                         for x, y in zip(a, b))
        rounds = []
        for _ in range(3):
            p1, m1, m2, p2 = (cs.graph_ms(lambda k=k: run(k)) for k in
                              (theirs, mine, mine, theirs))
            rounds.append(((m1 + m2) / 2, (p1 + p2) / 2))
        ratios = [m / p for m, p in rounds]
        ratio = statistics.median(ratios)
        ms = statistics.median(m for m, _ in rounds)
        pms = statistics.median(p for _, p in rounds)
        print(f"key {label:52s} bit-equal {equal}; graph this {ms:.4f} ms, "
              f"parent {pms:.4f} ms (this/parent {ratio:.3f}; rounds "
              + " ".join(f"{r:.3f}" for r in ratios) + ")", flush=True)
        if not equal:
            unequal.append(label)
        result["keys"].append({"label": label, "equal": equal, "ms": ms,
                               "parent_ms": pms, "ratio": ratio,
                               "rounds": ratios})
    ratios = sorted(r["ratio"] for r in result["keys"])
    print(f"{len(result['keys'])} keys in {time.perf_counter() - t0:.1f} s: "
          f"{len(unequal)} not bit-equal {unequal}; this/parent ratio "
          f"median {ratios[len(ratios) // 2]:.3f}, min {ratios[0]:.3f}, "
          f"max {ratios[-1]:.3f}", flush=True)
    if opts.out:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text(json.dumps(result, indent=1))
    return 1 if unequal else 0


if __name__ == "__main__":
    sys.exit(main())
