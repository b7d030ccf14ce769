"""SimulEval v1 REST client (the port's copy of
``neurst_tpu/utils/simuleval_agents/online_client.py``; no dependency on
the ``simuleval`` package).  It speaks the wire protocol of a SimulEval
server, so the wait-k agent can be scored by an unmodified one:

  GET  /                          -> corpus info {"num_sentences": N}
  GET  /src?instance_id=i         -> {"instance_id", "segment_id",
                                      "segment"} (one source unit;
                                      "</s>" when exhausted)
  PUT  /hypo?instance_id=i        -> body: the predicted unit ("</s>"
                                      terminates the instance)
  GET  /result                    -> evaluation scores JSON

It uses the standard library's ``urllib`` only.
"""

import json
import urllib.parse
import urllib.request
from typing import Optional

__all__ = ["SimulEvalClient", "DEFAULT_EOS", "READ_ACTION", "WRITE_ACTION"]

DEFAULT_EOS = "</s>"
READ_ACTION = "read"
WRITE_ACTION = "write"


class SimulEvalClient(object):

    def __init__(self, hostname: str = "localhost", port: int = 12321,
                 timeout: float = 60.0):
        self._base = f"http://{hostname}:{port}"
        self._timeout = timeout

    def _get(self, path: str, params: Optional[dict] = None):
        url = self._base + path
        if params:
            url += "?" + urllib.parse.urlencode(params)
        with urllib.request.urlopen(url, timeout=self._timeout) as r:
            body = r.read().decode("utf-8")
        return json.loads(body) if body else {}

    def corpus_info(self) -> dict:
        return self._get("")

    def get_source(self, instance_id: int,
                   extra_params: Optional[dict] = None) -> dict:
        params = {"instance_id": instance_id}
        if extra_params:
            params.update(extra_params)
        return self._get("/src", params)

    def send_hypo(self, instance_id: int, hypo: str) -> None:
        url = (f"{self._base}/hypo?"
               + urllib.parse.urlencode({"instance_id": instance_id}))
        req = urllib.request.Request(
            url, data=hypo.encode("utf-8"), method="PUT")
        with urllib.request.urlopen(req, timeout=self._timeout):
            pass

    def get_scores(self) -> dict:
        return self._get("/result")
