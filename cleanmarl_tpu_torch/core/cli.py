"""Tiny tyro-compatible CLI built from a flat ``@dataclass`` (port of
``cleanmarl_tpu/core/cli.py``, without the multi-host bootstrap): each
field is ``--field_name`` (and ``--field-name``), typed from the
annotation, with the dataclass default.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Sequence, Type, TypeVar

T = TypeVar("T")


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "1"):
        return True
    if v.lower() in ("no", "false", "f", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def cli(cls: Type[T], args: Optional[Sequence[str]] = None,
        description: str = "") -> T:
    if not dataclasses.is_dataclass(cls):
        raise TypeError("cli() expects a dataclass")
    parser = argparse.ArgumentParser(
        description=description or (cls.__doc__ or ""),
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    for field in dataclasses.fields(cls):
        if not field.init:
            continue
        names = [f"--{field.name}"]
        if "_" in field.name:
            names.append(f"--{field.name.replace('_', '-')}")
        ftype = field.type
        if isinstance(ftype, str):  # from __future__ annotations
            ftype = {"int": int, "float": float, "str": str, "bool": bool}.get(ftype, str)
        if ftype is bool:
            parser.add_argument(*names, type=_str2bool, default=field.default, help=" ")
        else:
            parser.add_argument(*names, type=ftype, default=field.default, help=" ")
    ns = parser.parse_args(args)
    return cls(**{f.name: getattr(ns, f.name) for f in dataclasses.fields(cls) if f.init})
