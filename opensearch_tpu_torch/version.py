"""Version constants (a copy of the JAX package's ``version.py``),
analog of libs/core Version (reference:
libs/core/src/main/java/org/opensearch/core/Version.java).

The wire/index format version is independent of the package version; it is
persisted in segment metadata and the translog header and checked on read.
"""

__version__ = "0.1.0"

# Bump when the on-disk segment layout changes incompatibly.
INDEX_FORMAT_VERSION = 1
# Bump when the translog record framing changes incompatibly.
TRANSLOG_FORMAT_VERSION = 1
# Wire protocol version for the node-to-node transport layer:
# major*100 + minor.  Handshakes negotiate min(local, remote) and refuse
# a major mismatch (TransportHandshaker analog).
TRANSPORT_PROTOCOL_VERSION = 101
