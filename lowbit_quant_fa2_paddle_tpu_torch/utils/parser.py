"""Benchmark CLI flags (reference utils/parser_util.py:4-21)."""

from __future__ import annotations

import argparse


def bench_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="low-bit attention benchmarks")
    p.add_argument("--method", default="lowbit", choices=["lowbit", "fa2", "exact"],
                   help="attention backend (reference --method {fa2,torch,xformers})")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_heads", type=int, default=32)
    p.add_argument("--head_dim", type=int, default=64)
    p.add_argument("--seq_lens", type=int, nargs="+",
                   default=[1024, 2048, 4096, 8192, 16384, 32768])
    p.add_argument("--bits", default="int8",
                   choices=["fp", "int8", "int8_v8", "int4", "int2", "auto"])
    p.add_argument("--causal", action="store_true")
    p.add_argument("--quant_gran", default="per_token",
                   choices=["per_token", "per_block", "per_warp", "per_thread"])
    p.add_argument("--output", default=None, help="JSON results path")
    return p


def save_name(args: argparse.Namespace) -> str:
    """Filename from the arg dict (reference parser_util.py:15-20)."""
    keys = ["method", "bits", "batch_size", "num_heads", "head_dim"]
    return "_".join(f"{k}-{getattr(args, k)}" for k in keys if hasattr(args, k))
