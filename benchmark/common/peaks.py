"""The card's peak rates and the bound of a piece of work (a frozen copy).

Copied from ``chip_smoke.py`` (``PEAKS``, ``peaks_for``, ``bound``, the MUFU
ex2 rate of ``flash_bound``), so that later changes to the smoke script do
not move the yardstick.  The tensor-core rates are NVIDIA's dense data-sheet
numbers (the sheets print twice these, with sparsity).
"""

from __future__ import annotations

#: fp32 outside the tensor cores, bf16 and int8 tensor cores, memory bytes/s
PEAKS = {
    "PCIe": {"float32": 51e12, "bfloat16": 756e12, "int8": 1513e12, "bytes": 2.0e12},
    "NVL": {"float32": 60e12, "bfloat16": 835e12, "int8": 1670e12, "bytes": 3.9e12},
    "SXM": {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12, "bytes": 3.35e12},
}

#: MUFU ex2 results a clock per SM on sm_90 (the CUDA C++ Programming Guide's
#: table of arithmetic instruction throughput)
MUFU_EX2_PER_SM_CLOCK = 16
#: the H100 SXM's SM count and its maximum SM clock (``nvidia-smi``
#: clocks.max.sm reads 1980 MHz on the card these bounds were set on)
H100_SXM_SMS = 132
H100_SXM_MAX_MHZ = 1980.0


def peaks_for(name: str) -> dict[str, float]:
    """The peak table of the card named ``name`` (the SXM part's when the
    name says neither PCIe nor NVL), with the MUFU ex2 rate under "exp"."""
    key = next((k for k in ("PCIe", "NVL") if k in name), "SXM")
    return {**PEAKS[key], "exp": MUFU_EX2_PER_SM_CLOCK * H100_SXM_SMS * H100_SXM_MAX_MHZ * 1e6}


def bound_s(flops: float, nbytes: float, peak_ops: float, peaks: dict[str, float],
            exps: float = 0.0) -> tuple[float, str]:
    """The least time for the work, in seconds: the largest of operations
    over the peak rate of their type, bytes (each input read once, each
    output written once) over the memory rate and ``exps`` exponentials over
    the MUFU's ex2 rate; and which of them binds."""
    terms = {"operations": flops / peak_ops, "bytes": nbytes / peaks["bytes"]}
    if exps:
        terms["exp"] = exps / peaks["exp"]
    by = max(terms, key=terms.get)
    return terms[by], by
