"""Multiprocess cluster runtime: head, node daemon, workers, transport.

Layer map (each module cites its reference counterpart):
  protocol.py        framed RPC w/ retries + chaos   (src/ray/rpc/)
  head.py            global control service          (src/ray/gcs/gcs_server/)
  node.py            per-node daemon + worker pool   (src/ray/raylet/)
  worker_main.py     worker process execute loop     (src/ray/core_worker/ exec side)
  cluster_backend.py owner-side submission/transport (src/ray/core_worker/ submit side)
  object_plane.py    shm store + ownership/transfer  (src/ray/object_manager/)
  wire.py            spec wire format                (src/ray/protobuf/common.proto)
"""
