"""dwpa-compatible work server: scheduler, ingestion, verification, jobs.

A from-scratch reimplementation of the reference's PHP/MySQL server stack
(web/common.php, web/content/*, web/maint.php, web/rkg.php, db/wpa.sql) on
sqlite + stdlib WSGI, speaking the same JSON protocol as the reference so
either client works against either server.  Its pre-crack derives PMKs
through the PBKDF2 CUDA kernel on ``cuda:0`` (``precrack.py``).
"""

from .db import Database  # noqa: F401
from .core import ServerCore  # noqa: F401
from .api import make_wsgi_app  # noqa: F401
