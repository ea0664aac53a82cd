"""Compute Engine A3 node provider: one H100 VM per autoscaler node.

The port of the JAX package's TPU-VM provider (``ray_tpu/providers/
gcp_tpu.py``), role-equivalent to the reference's GCP provider
(reference: python/ray/autoscaler/_private/gcp/node_provider.py). The
provisioning unit is one A3 VM (``a3-highgpu-{1,2,4,8}g``: 1 to 8 H100
80GB cards on one host) whose startup script boots the node daemon; the
daemon detects its cards and advertises ``GPU`` and ``GPU-H100``
(``accelerators/gpu.py``), so a pending ``{"GPU": 1, "GPU-H100": 1}``
bundle scales up exactly one VM. There is no gang resource: a VM is one
host.

All HTTP goes through an injectable transport (tests use a fake). Real
deployments default to urllib against ``compute.googleapis.com`` with a
GCE-metadata access token.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.autoscaler import NodeProvider
from ray_tpu_torch.util.fault_injector import fire

logger = logging.getLogger("ray_tpu_torch.providers.gce")

_COMPUTE_API = "https://compute.googleapis.com/compute/v1"
_METADATA_TOKEN_URL = ("http://metadata.google.internal/computeMetadata/v1/"
                       "instance/service-accounts/default/token")

#: the VM's startup: join the cluster as a node daemon. The daemon
#: detects its cards itself (accelerators/gpu.py reads nvidia-smi), so
#: the script only carries identity and the head's address.
_STARTUP_TEMPLATE = """#!/bin/bash
python3 -m ray_tpu_torch.runtime.node {head_addr} {session} \
'{{"resources": null, "object_store_bytes": null, \
"node_id": "{node_id}", "config": {config}}}'
"""

#: A3 machine types -> (H100 80GB cards, vCPUs), from Compute Engine's
#: accelerator-optimized machine family table
A3_TYPES = {"a3-highgpu-1g": (1, 26), "a3-highgpu-2g": (2, 52),
            "a3-highgpu-4g": (4, 104), "a3-highgpu-8g": (8, 208)}

#: the boot disk's size (GB): the image, the CUDA stack, the kernels' builds
_BOOT_DISK_GB = 200

#: instance statuses of a VM that is coming up or alive; any other
#: (STOPPING, STOPPED, SUSPENDING, SUSPENDED, TERMINATED) is dead
_LIVE = ("PROVISIONING", "STAGING", "RUNNING", "REPAIRING", "")


class _UrllibHttp:
    """Minimal JSON-over-HTTP transport (stdlib only; no cloud SDK)."""

    def __init__(self, token_fn: Optional[Callable[[], str]] = None):
        self._token_fn = token_fn or self._metadata_token

    @staticmethod
    def _metadata_token() -> str:
        import urllib.request
        req = urllib.request.Request(
            _METADATA_TOKEN_URL, headers={"Metadata-Flavor": "Google"})
        with urllib.request.urlopen(req, timeout=10) as resp:
            return json.loads(resp.read())["access_token"]

    def request(self, method: str, url: str,
                body: Optional[dict] = None) -> dict:
        import urllib.request
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Authorization": f"Bearer {self._token_fn()}",
                     "Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            payload = resp.read()
            return json.loads(payload) if payload else {}


class _InstanceHandle:
    """Provider handle for one provisioned VM.

    ``poll()`` follows the Popen contract the autoscaler's adoption loop
    checks (None = still coming up / alive, non-None = dead): it GETs the
    instance (throttled) so an async create failure (quota, stockout, a
    boot error) frees the launch slot instead of pinning max_workers.
    """

    _POLL_INTERVAL_S = 15.0

    _FAILS_BEFORE_DEAD = 3  # consecutive GET failures before declaring

    def __init__(self, name: str, node_id: str, http: Any):
        self.name = name             # the instance's resource URL
        self.rtpu_node_id = node_id  # identity the daemon registers under
        self._http = http
        self._last_poll = 0.0
        self._dead: Optional[str] = None
        self._fails = 0

    def poll(self) -> Optional[str]:
        if self._dead is not None:
            return self._dead
        now = time.monotonic()
        if now - self._last_poll < self._POLL_INTERVAL_S:
            return None
        self._last_poll = now
        try:
            status = self._http.request("GET", self.name).get("status", "")
        except Exception:  # noqa: BLE001 — a 404 (deleted) or a transient
            # API hiccup: one blip must not orphan a billing VM, so only
            # consecutive failures count
            self._fails += 1
            if self._fails >= self._FAILS_BEFORE_DEAD:
                self._dead = "GONE"
            return self._dead
        self._fails = 0
        if status in _LIVE:
            return None
        self._dead = status
        return self._dead


class GceGpuNodeProvider(NodeProvider):
    """Provision/release A3 VMs through the Compute Engine REST API.

    Parameters mirror what a cluster config would carry: the project and
    zone, the ``machine_type`` (an ``A3_TYPES`` key), the boot ``image``
    (an image URL with the CUDA stack and this package installed), and
    the head address new VMs join.
    """

    def __init__(self, project: str, zone: str, machine_type: str,
                 image: str, head_addr: str, session: str,
                 http: Optional[Any] = None, name_prefix: str = "rtpt"):
        self.project = project
        self.zone = zone
        self.machine_type = machine_type
        self.image = image
        self.head_addr = head_addr
        self.session = session
        self.http = http or _UrllibHttp()
        self.name_prefix = name_prefix

    @property
    def _instances(self) -> str:
        return (f"{_COMPUTE_API}/projects/{self.project}/zones/{self.zone}"
                f"/instances")

    def _name_for(self, node_id: str) -> str:
        """Deterministic instance name for a node identity: what lets a
        restarted autoscaler terminate an orphaned VM from nothing but
        the persisted instance record."""
        return f"{self.name_prefix}-{node_id[:12]}"

    def create_node(self, resources: Dict[str, float],
                    node_id: Optional[str] = None) -> _InstanceHandle:
        from ray_tpu_torch.core import config as config_mod
        from ray_tpu_torch.core.ids import NodeID
        fire("provider.create")
        node_id = node_id or NodeID.from_random().hex()
        name = self._name_for(node_id)
        startup = _STARTUP_TEMPLATE.format(
            head_addr=self.head_addr, session=self.session,
            node_id=node_id, config=config_mod.GlobalConfig.to_json())
        body = {
            "name": name,
            "machineType": f"zones/{self.zone}/machineTypes/"
                           f"{self.machine_type}",
            "disks": [{"boot": True, "autoDelete": True,
                       "initializeParams": {"sourceImage": self.image,
                                            "diskSizeGb": _BOOT_DISK_GB}}],
            "networkInterfaces": [{"network": "global/networks/default"}],
            # GPU VMs cannot live-migrate
            "scheduling": {"onHostMaintenance": "TERMINATE"},
            "metadata": {"items": [{"key": "startup-script",
                                    "value": startup}]},
            "labels": {"rtpt-session": self.session,
                       "rtpt-node-id": node_id[:32]},
        }
        logger.info("provisioning GCE instance %s (%s)", name,
                    self.machine_type)
        self.http.request("POST", self._instances, body)
        return _InstanceHandle(f"{self._instances}/{name}", node_id,
                               self.http)

    def terminate_node(self, handle: _InstanceHandle) -> None:
        fire("provider.terminate")
        logger.info("releasing GCE instance %s",
                    handle.name.rsplit("/", 1)[-1])
        try:
            self.http.request("DELETE", handle.name)
        except Exception:  # noqa: BLE001 — already gone / API hiccup
            logger.exception("instance delete failed: %s", handle.name)

    def describe(self, handle: _InstanceHandle) -> Dict[str, Any]:
        return {"name": handle.name}

    def list_live(self) -> Dict[str, Dict[str, Any]]:
        """The provider's live-handle ledger: every not-yet-deleted VM of
        this session, keyed by the rtpt-node-id label it was created
        with: the substrate restart reconcile converges against."""
        items = []
        url = self._instances
        try:
            while True:
                page = self.http.request("GET", url)
                items += page.get("items", [])
                token = page.get("nextPageToken")
                if not token:
                    break
                url = f"{self._instances}?pageToken={token}"
        except Exception:  # noqa: BLE001 — API down: report nothing
            logger.exception("GCE instance list failed")
            return {}
        out: Dict[str, Dict[str, Any]] = {}
        for inst in items:
            labels = inst.get("labels") or {}
            if labels.get("rtpt-session") != self.session:
                continue
            nid = labels.get("rtpt-node-id")
            if nid and inst.get("status") not in ("STOPPING", "TERMINATED"):
                out[nid] = {"name": f"{self._instances}/"
                                    f"{inst.get('name', '')}"}
        return out

    def terminate_orphan(self, node_id: str,
                         metadata: Dict[str, Any]) -> None:
        fire("provider.terminate")
        name = metadata.get("name") or \
            f"{self._instances}/{self._name_for(node_id)}"
        logger.info("releasing orphaned GCE instance %s",
                    name.rsplit("/", 1)[-1])
        try:
            self.http.request("DELETE", name)
        except Exception:  # noqa: BLE001 — already gone
            logger.exception("orphan instance delete failed: %s", name)

    @staticmethod
    def node_type(machine_type: str,
                  cpus: Optional[float] = None) -> Dict[str, float]:
        """The resource shape the VM's daemon registers: what the
        autoscaler bin-packs demand against. ``cpus`` overrides the
        machine type's vCPU count."""
        if machine_type not in A3_TYPES:
            raise ValueError(f"unknown machine type {machine_type!r}; "
                             f"known: {sorted(A3_TYPES)}")
        cards, vcpus = A3_TYPES[machine_type]
        return {"CPU": float(vcpus if cpus is None else cpus),
                "GPU": float(cards), "GPU-H100": float(cards)}
