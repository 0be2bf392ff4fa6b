"""Cluster communication layer.

Counterpart of ``ceph_tpu/msg``: a re-expression of the reference
messenger (reference:src/msg/), a `Messenger`/`Connection`/`Dispatcher`
triple carrying typed messages (reference:src/msg/Message.h,
reference:src/messages/) with crc-checked binary framing
(reference:src/msg/Messenger.cc:51-64) over asyncio TCP.  Its frames
are the reference package's byte for byte, so daemons of the two
packages talk to each other.
"""

from .message import (
    Message,
    decode_frame,
    decode_frame_msgs,
    encode_frame,
    encode_frame_segments,
    register,
)
from . import messages
from .messenger import AsyncMessenger, Connection, Dispatcher

__all__ = [
    "Message",
    "messages",
    "encode_frame",
    "encode_frame_segments",
    "decode_frame",
    "decode_frame_msgs",
    "register",
    "AsyncMessenger",
    "Connection",
    "Dispatcher",
]
