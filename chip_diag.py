#!/usr/bin/env python3
"""What bounds a split-D flash backward kernel on the card: builds of
csrc/flash_attn_bwd.cu with one part of a kernel taken out or changed.

    python3 chip_diag.py [VARIANT_PREFIX ...]

Needs one CUDA GPU (Hopper) and nvcc. For the 16-bit split-D dK/dV
(`flash_bwd_dkv_split_d_wgmma_kernel`, bf16, variants "dkv_"), the fp32
split-D dQ (`flash_bwd_dq_split_d_tf32_kernel`, "dq_"), the fp32 split-D
dK/dV (`flash_bwd_dkv_split_d_tf32_kernel`, "tdkv_") and the 16-bit
split-D dQ (`flash_bwd_dq_split_d_wgmma_kernel`, bf16, "dq16_") it
builds, one nvcc each and all at once, a copy of the source with the
kernel's TMA loads after the ring's first fill dropped (the stage
barriers still complete), with its score products dropped, with its
second products dropped, or with all three dropped (timing only: these
compute wrong results); one with each dQ's chunk held at 128 columns a
warpgroup for every D (the narrowest the kernel has; right results, the
scores recomputed in each of n chunks); and one with the 16-bit dQ's
stage release taken back to one arrival per consumer thread (256 a
stage, as in the dK/dV) from one per consumer warpgroup (right results).
The builds with right results are held against the plain versions (1e-4
fp32, 2e-2 bf16). It times each build's kernels (device ms per call,
chip_smoke.device_ms) at [8, 4, 512, 512] and [8, 4, 512, 768] on the
head-split views, and the fp32 ones also at [8, 8, 512, 256] (one chunk:
the fp32 D = 256 dQ and dK/dV run these kernels), beside the unchanged
source, in two rounds. Arguments, if any, keep only the variants whose
names start with one of them (the unchanged source always runs). One
JSON line per build and round, after the card's name and power limit.
"""
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DKV = "flash_bwd_dkv_split_d_wgmma_kernel(const"
DQ = "flash_bwd_dq_split_d_tf32_kernel(const"
TDKV = "flash_bwd_dkv_split_d_tf32_kernel(const"
DQ16 = "flash_bwd_dq_split_d_wgmma_kernel(const"
# variant -> (the kernel it changes, [(text, replacement)] applied to the
# first occurrence after the kernel's definition)
VARIANTS = {
    "unchanged": (DQ, []),
    "dkv_no_loads": (DKV, [(
        "        hopper::mbar_arrive_expect_tx(full + s, L::STAGE);\n"
        "        if (j < nbox) {",
        "        if (i >= STAGES) { hopper::mbar_arrive(full + s); continue; }\n"
        "        hopper::mbar_arrive_expect_tx(full + s, L::STAGE);\n"
        "        if (j < nbox) {")]),
    "dkv_no_score_products": (DKV, [(
        "          Wgmma<BQ, 0, T>::ss(\n              acc,",
        "          if (!n_chunks) Wgmma<BQ, 0, T>::ss(\n              acc,")]),
    "dkv_no_second_products": (DKV, [
        ("          Wgmma<L::COLS, 1, T>::rs(\n              dv_acc[b]",
         "          if (!n_chunks) Wgmma<L::COLS, 1, T>::rs(\n"
         "              dv_acc[b]"),
        ("          Wgmma<L::COLS, 1, T>::rs(\n              dk_acc[b]",
         "          if (!n_chunks) Wgmma<L::COLS, 1, T>::rs(\n"
         "              dk_acc[b]")]),
    "dq_no_loads": (DQ, [(
        "    if (i >= total) return;\n",
        "    if (i >= total) return;\n    if (i >= L::STAGES) {\n"
        "      hopper::mbar_arrive(full + i % L::STAGES);\n      return;\n"
        "    }\n")]),
    "dq_no_score_products": (DQ, [(
        "            mma3(part[n], ahi, alo, bhi, blo);",
        "            if (!n_chunks) mma3(part[n], ahi, alo, bhi, blo);")]),
    "dq_no_second_products": (DQ, [(
        "            mma3(acc[(2 * cs + b) * CT + jj], ahi, alo, bhi, blo);",
        "            if (!n_chunks)\n"
        "              mma3(acc[(2 * cs + b) * CT + jj], ahi, alo, bhi, blo);")]),
    "tdkv_no_loads": (TDKV, [(
        "    if (i >= total) return;\n",
        "    if (i >= total) return;\n    if (i >= L::STAGES) {\n"
        "      hopper::mbar_arrive(full + i % L::STAGES);\n      return;\n"
        "    }\n")]),
    "tdkv_no_score_products": (TDKV, [(
        "            mma3(part[n], ahi, alo, bhi, blo);",
        "            if (!n_chunks) mma3(part[n], ahi, alo, bhi, blo);")]),
    "tdkv_no_second_products": (TDKV, [
        ("          mma3(dv_acc[cs * CT + jj], phi, plo, bhi, blo);",
         "          if (!n_chunks)\n"
         "            mma3(dv_acc[cs * CT + jj], phi, plo, bhi, blo);"),
        ("          mma3(dk_acc[cs * CT + jj], shi, slo, bhi, blo);",
         "          if (!n_chunks)\n"
         "            mma3(dk_acc[cs * CT + jj], shi, slo, bhi, blo);")]),
    "dq_chunk_128": (DQ, [("  if (D % 512 == 0)\n", "  if (false)\n"),
                          ("  if (D % 384 == 0)\n", "  if (false)\n")]),
    "dq16_no_loads": (DQ16, [(
        "        if (j < nbox) {  // a score step",
        "        if (i >= STAGES) { hopper::mbar_arrive(full + s); continue; }\n"
        "        if (j < nbox) {  // a score step")]),
    "dq16_no_score_products": (DQ16, [(
        "          Wgmma<BK, 0, T>::ss(\n              acc,",
        "          if (!n_chunks) Wgmma<BK, 0, T>::ss(\n              acc,")]),
    "dq16_no_second_products": (DQ16, [(
        "            Wgmma<L::COLS, 1, T>::rs(\n                dq_acc",
        "            if (!n_chunks) Wgmma<L::COLS, 1, T>::rs(\n"
        "                dq_acc")]),
    "dq16_chunk_128": (DQ16, [("  if (n % 2 == 0)\n", "  if (false)\n"),
                              ("  if (n % 3 == 0)\n", "  if (false)\n")]),
    "dq16_empty_256": (DQ16, [
        ("      hopper::mbar_init(empty + s, 2);",
         "      hopper::mbar_init(empty + s, 2 * 128);"),
        ("      if (tid == 0) hopper::mbar_arrive(empty + s);",
         "      hopper::mbar_arrive(empty + s);")]),
}
# the builds that compute right results: held against the plain versions
CHECKED = ("dq_chunk_128", "dq16_chunk_128", "dq16_empty_256")
# the skeletons of the split-D kernels: their barriers, exchange, softmax
# and epilogue alone
for _k, _m in (("dkv", DKV), ("dq", DQ), ("tdkv", TDKV), ("dq16", DQ16)):
    VARIANTS[f"{_k}_no_loads_no_products"] = (_m, [
        r for v in ("no_loads", "no_score_products", "no_second_products")
        for r in VARIANTS[f"{_k}_{v}"][1]])


def variant_source(src, marker, reps):
    start = src.index(marker)
    head, tail = src[:start], src[start:]
    for old, new in reps:
        if old not in tail:
            raise AssertionError(f"{marker}: no {old!r} to replace")
        tail = tail.replace(old, new, 1)
    return head + tail


def main():
    keep = sys.argv[1:]
    for name in list(VARIANTS):
        if name != "unchanged" and keep and \
                not any(name.startswith(k) for k in keep):
            del VARIANTS[name]
    import torch
    if not torch.cuda.is_available():
        print("chip_diag: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from paddle_tpu_torch.core import kernel_build
    from paddle_tpu_torch.ops import attention as attn
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)

    out_dir = tempfile.mkdtemp(prefix="chip_diag_")
    try:
        run(torch, cs, kernel_build, attn, out_dir)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return 0


def run(torch, cs, kernel_build, attn, out_dir):
    csrc = kernel_build.CSRC_DIR
    src = open(os.path.join(csrc, "flash_attn_bwd.cu")).read()
    nvcc = kernel_build.find_nvcc()
    procs, sources = {}, []
    try:
        for name, (marker, reps) in VARIANTS.items():
            # beside the original, so that its #include "*.cuh" resolve
            path = os.path.join(csrc, f"_diag_{name}.cu")
            sources.append(path)
            with open(path, "w") as f:
                f.write(variant_source(src, marker, reps))
            procs[name] = subprocess.Popen(
                [nvcc, *kernel_build.NVCC_FLAGS, "-o",
                 os.path.join(out_dir, f"{name}.so"), path],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        t0 = time.perf_counter()
        for name, p in procs.items():
            log = p.communicate()[0]
            if p.returncode:
                raise RuntimeError(f"{name}: nvcc failed\n{log[-3000:]}")
        print(json.dumps({"phase": "build",
                          "s": time.perf_counter() - t0}), flush=True)
    finally:
        for path in sources:
            os.remove(path)

    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, refs = {}, {}
    # head dim -> heads of the [8, H, 512, D] views; at D = 256 the 16-bit
    # dQ and dK/dV are the wgmma256 kernels, not split-D: fp32 only there
    for d, h in ((256, 8), (512, 4), (768, 4)):
        for dt, kind in ((torch.float32, "dq"), (torch.float32, "tdkv"),
                         (torch.bfloat16, "dkv"), (torch.bfloat16, "dq16")):
            if d == 256 and dt != torch.float32:
                continue
            q, k, v, do = (cs.attention_inputs(torch, gen, 8, h, 512, d, dt,
                                               True) for _ in range(4))
            out, lse = attn.flash_attention_cuda(q, k, v)
            dd = (do.float() * out.float()).sum(-1)
            args = (q, k, v, do, lse, dd, False)
            key = f"{kind}_d{d}_ms"
            if kind in ("dkv", "tdkv"):
                cases[key] = (attn.flash_attention_bwd_dkv_cuda, args)
            else:
                cases[key] = (attn.flash_attention_bwd_dq_cuda, args)
                refs[key] = (attn.flash_attention_bwd_dq_plain(*args),
                             cs.TOL[cs.dtype_name(dt)])
    for rnd in range(2):
        for name in VARIANTS:
            # the wrappers load the library through kernel_build's cache
            kernel_build._loaded["flash_attn_bwd"] = ctypes.CDLL(
                os.path.join(out_dir, f"{name}.so"))
            row = {"variant": name, "round": rnd}
            for key, (fn, args) in cases.items():
                if name in CHECKED and key.startswith(name.split("_")[0] +
                                                      "_d"):
                    ref, tol = refs[key]
                    torch.testing.assert_close(fn(*args).float(),
                                               ref.float(), rtol=tol,
                                               atol=tol)
                row[key] = cs.device_ms(torch, lambda: fn(*args), 10)
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    sys.exit(main())
