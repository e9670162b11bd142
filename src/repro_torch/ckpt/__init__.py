"""Checkpointing: sharded npz + manifest, async writer, TWA writer gate."""

from .checkpoint import (AsyncCheckpointer, WriterGate, latest_step, restore,
                         save)

__all__ = ["save", "restore", "latest_step", "AsyncCheckpointer", "WriterGate"]
