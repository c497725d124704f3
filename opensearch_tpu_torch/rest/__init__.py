"""The REST layer: ``RestController`` (``rest/controller.py``) and the
HTTP server (``rest/http_server.py``)."""
