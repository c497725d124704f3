"""Node: service wiring + lifecycle + CLI entry point (the port of the JAX
package's ``node.py``).

Analog of ``node/Node.java`` and ``bootstrap/OpenSearch.main`` at
single-node scope: the indices service, the search pipelines
(``search/pipeline.py``, persisted under the data path), the REST
controller and the HTTP transport, serving on one device: ``cuda``
unless the caller asks for ``"cpu"``.  Without CUDA a node that did not
ask for the CPU raises ``DeviceUnavailableError`` when it is built,
before it creates anything on disk.

The reference node's other services are not ported (ROADMAP Queue A):
snapshots, ingest pipelines, reader contexts (scroll and point in time),
tasks, search backpressure, identity, query insights, QoS, persistent
tasks, the dynamic cluster settings and the bootstrap checks.  Their
routes answer 501.

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

from opensearch_tpu_torch.common.torchenv import (DeviceUnavailableError,
                                                  resolve_device)
from opensearch_tpu_torch.indices.service import IndicesService
from opensearch_tpu_torch.rest.controller import RestController
from opensearch_tpu_torch.rest.http_server import HttpServer
from opensearch_tpu_torch.search.engine import query_engine
from opensearch_tpu_torch.search.pipeline import SearchPipelineService


class Node:
    def __init__(self, data_path: str, name: str = "node-1",
                 cluster_name: str = "opensearch-tpu",
                 host: str = "127.0.0.1", port: int = 9200, device=None):
        self.device = resolve_device(device)
        self.name = name
        self.host = host
        self.cluster_name = cluster_name
        self.cluster_uuid = uuid.uuid4().hex[:22]
        self.data_path = data_path
        os.makedirs(data_path, exist_ok=True)
        self.indices = IndicesService(os.path.join(data_path, "indices"),
                                      device=self.device)
        self.search_pipelines = SearchPipelineService(data_path)
        self.rest = RestController(self)
        self.http = HttpServer(self.rest, host=host, port=port)
        self._stopped = False

    @property
    def port(self) -> int:
        return self.http.port

    def start(self) -> "Node":
        self.http.start()
        return self

    def stop(self):
        """Idempotent (and safe when ``start()`` never ran): stops the
        HTTP server, closes every index and joins the query engine's
        worker threads."""
        if self._stopped:
            return
        self._stopped = True
        self.http.stop()
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
    args = ap.parse_args(argv)

    try:
        node = Node(args.data_path, name=args.name,
                    cluster_name=args.cluster_name, host=args.host,
                    port=args.port, device=args.device).start()
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
