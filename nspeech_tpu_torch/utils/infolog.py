"""Run logging: stdout, an appended log file and, only when a webhook URL
is given, Slack. A copy of ``nspeech_tpu/utils/infolog.py``: ``Logger``
instances are explicit, and a module-level default serves the CLIs.
"""

from __future__ import annotations

import atexit
import json
from datetime import datetime
from threading import Thread
from typing import Optional
from urllib.request import Request, urlopen

_FORMAT = "%Y-%m-%d %H:%M:%S.%f"


class Logger:
    def __init__(self, filename: Optional[str] = None,
                 run_name: Optional[str] = None,
                 slack_url: Optional[str] = None, quiet: bool = False):
        self._quiet = quiet   # a data-parallel rank other than 0 logs nothing
        self._file = open(filename, "a") if filename else None
        if self._file:
            self._file.write("\n" + "-" * 65 + "\n")
            self._file.write("Starting new run\n")
            self._file.write("-" * 65 + "\n")
        self._run_name = run_name
        self._slack_url = slack_url
        atexit.register(self.close)

    def log(self, msg: str, slack: bool = False) -> None:
        if self._quiet:
            return
        print(msg, flush=True)
        if self._file is not None:
            stamp = datetime.now().strftime(_FORMAT)[:-3]
            self._file.write(f"[{stamp}]  {msg}\n")
            self._file.flush()
        if slack and self._slack_url:
            Thread(target=self._send_slack, args=(msg,), daemon=True).start()

    def _send_slack(self, msg: str) -> None:
        try:
            req = Request(self._slack_url)
            req.add_header("Content-Type", "application/json")
            urlopen(req, json.dumps({
                "username": "nspeech-tpu",
                "icon_emoji": ":speaker:",
                "text": f"*{self._run_name}*: {msg}",
            }).encode())
        except Exception:
            pass  # observability must not kill training

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


_default = Logger()


def init(filename: Optional[str], run_name: str,
         slack_url: Optional[str] = None, quiet: bool = False) -> Logger:
    global _default
    _default.close()
    _default = Logger(filename, run_name, slack_url, quiet)
    return _default


def log(msg: str, slack: bool = False) -> None:
    _default.log(msg, slack=slack)
