"""Node: service wiring + lifecycle + CLI entry point (the port of the JAX
package's ``node.py``).

Analog of ``node/Node.java`` and ``bootstrap/OpenSearch.main`` at
single-node scope: the indices service, the search pipelines
(``search/pipeline.py``, persisted under the data path), the reader
contexts of scroll and point in time (``search/contexts.py``), the REST
controller and the HTTP transport, serving on one device: ``cuda``
unless the caller asks for ``"cpu"``.  Without CUDA a node that did not
ask for the CPU raises ``DeviceUnavailableError`` when it is built,
before it creates anything on disk.

Node settings (``settings``, or ``-E key=value`` on the command line)
read at start: ``device.memory.budget_bytes`` (the residency ledger's
device budget, ``common/device_ledger.py`` ``set_budget``; 0 = none) and
``device.pager.page_bytes`` (the quantized pager's page, ``set_page_bytes``),
byte sizes such as ``"2gb"``.  The ledger is process-wide: a node that
names neither leaves it as it is.  Changing them through
``PUT _cluster/settings`` waits for the dynamic settings registry.

The reference node's other services are not ported (ROADMAP Queue A):
snapshots, ingest pipelines, tasks, search backpressure, identity, query
insights, QoS, persistent tasks, the dynamic cluster settings (so
``search.max_keep_alive``, ``search.default_keep_alive`` and
``search.max_open_scroll_context`` keep their defaults) and the
bootstrap checks.  Their routes answer 501.

Run: ``python -m opensearch_tpu_torch.node --port 9200 --data-path ./data``
(``--device cpu`` to serve on the CPU).
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import threading
import uuid
from typing import Optional

from opensearch_tpu_torch.common.breakers import breaker_service
from opensearch_tpu_torch.common.device_ledger import (device_ledger,
                                                       device_pager)
from opensearch_tpu_torch.common.settings import parse_bytes
from opensearch_tpu_torch.common.torchenv import (DeviceUnavailableError,
                                                  resolve_device)
from opensearch_tpu_torch.indices.service import IndicesService
from opensearch_tpu_torch.rest.controller import RestController
from opensearch_tpu_torch.rest.http_server import HttpServer
from opensearch_tpu_torch.search.contexts import ReaderContextRegistry
from opensearch_tpu_torch.search.engine import query_engine
from opensearch_tpu_torch.search.pipeline import SearchPipelineService


class Node:
    def __init__(self, data_path: str, name: str = "node-1",
                 cluster_name: str = "opensearch-tpu",
                 host: str = "127.0.0.1", port: int = 9200, device=None,
                 settings: Optional[dict] = None):
        self.device = resolve_device(device)
        # the fielddata breaker's default follows the card from the start
        breaker_service().size_for(self.device)
        self.settings = dict(settings or {})
        self._apply_device_settings()
        self.name = name
        self.host = host
        self.cluster_name = cluster_name
        self.cluster_uuid = uuid.uuid4().hex[:22]
        self.data_path = data_path
        os.makedirs(data_path, exist_ok=True)
        self.indices = IndicesService(os.path.join(data_path, "indices"),
                                      device=self.device)
        self.contexts = ReaderContextRegistry()
        self.search_pipelines = SearchPipelineService(data_path)
        self.rest = RestController(self)
        self.http = HttpServer(self.rest, host=host, port=port)
        self._stopped = False

    def _apply_device_settings(self) -> None:
        """``device.pager.page_bytes``, then ``device.memory.budget_bytes``
        (the budget enforces at once, with the pages it counts)."""
        if "device.pager.page_bytes" in self.settings:
            device_pager().set_page_bytes(
                parse_bytes(self.settings["device.pager.page_bytes"]))
        if "device.memory.budget_bytes" in self.settings:
            device_ledger().set_budget(
                parse_bytes(self.settings["device.memory.budget_bytes"]))

    @property
    def port(self) -> int:
        return self.http.port

    def start(self) -> "Node":
        self.http.start()
        return self

    def stop(self):
        """Idempotent (and safe when ``start()`` never ran): stops the
        HTTP server, closes the open scroll and PIT contexts (releasing
        their breaker charges), closes every index and joins the query
        engine's worker threads."""
        if self._stopped:
            return
        self._stopped = True
        self.http.stop()
        self.contexts.close_all()
        self.indices.close()
        query_engine().shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="opensearch-tpu-torch")
    ap.add_argument("--port", type=int, default=9200)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--data-path", default="./data")
    ap.add_argument("--name", default="node-1")
    ap.add_argument("--cluster-name", default="opensearch-tpu")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: cuda; "
                         "\"cpu\" to serve on the CPU)")
    ap.add_argument("-E", dest="settings", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="a node setting, e.g. -E "
                         "device.memory.budget_bytes=8gb")
    args = ap.parse_args(argv)
    settings = dict(kv.split("=", 1) for kv in args.settings)

    try:
        node = Node(args.data_path, name=args.name,
                    cluster_name=args.cluster_name, host=args.host,
                    port=args.port, device=args.device,
                    settings=settings).start()
    except DeviceUnavailableError as e:
        print(f"DeviceUnavailableError: {e}", file=sys.stderr)
        return 1
    print(f"[{args.name}] listening on http://{args.host}:{node.port} "
          f"(data: {args.data_path}, device: {node.device})", flush=True)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        node.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
