"""Device compute path: the jnp merge/split trees, compiled by XLA for the
backend jax runs on (``api.route`` decides when this path is taken)."""

from .coding import (
    FrameSpec,
    assemble_archive,
    decode,
    decode_batch_device,
    encode,
    encode_batch_device,
    measured_spec,
    plan_frame,
)

__all__ = [
    "FrameSpec",
    "assemble_archive",
    "decode",
    "decode_batch_device",
    "encode",
    "encode_batch_device",
    "measured_spec",
    "plan_frame",
]
