"""Pluggable mail delivery for the user-key flows.

The reference bundles PHPMailer (web/mail.php + web/m/, ~5.3k LoC) purely
to send two messages: the initial "here is your key" mail and the 24h
key-reset confirmation link (web/index.php:66-99).  Here that surface is
a two-method seam: production uses SmtpMailer (stdlib smtplib), tests use
CapturingMailer, and a core with ``mailer=None`` simply skips delivery —
the same observable behavior as the reference's swallowed mail exceptions
(index.php:72, 96: ``catch (Exception $e) { }``).
"""

import smtplib
from email.message import EmailMessage


class Mailer:
    """Interface: deliver one plain-text message; errors must not raise
    into the request path (reference swallows them too)."""

    def send(self, to: str, subject: str, body: str) -> bool:
        raise NotImplementedError


class CapturingMailer(Mailer):
    """Test double: records (to, subject, body) tuples."""

    def __init__(self):
        self.sent = []

    def send(self, to: str, subject: str, body: str) -> bool:
        self.sent.append((to, subject, body))
        return True


class SmtpMailer(Mailer):
    def __init__(self, host: str = "localhost", port: int = 25,
                 sender: str = "noreply@localhost",
                 username: str = None, password: str = None,
                 starttls: bool = False):
        self.host, self.port, self.sender = host, port, sender
        self.username, self.password = username, password
        self.starttls = starttls

    def send(self, to: str, subject: str, body: str) -> bool:
        msg = EmailMessage()
        msg["From"] = self.sender
        msg["To"] = to
        msg["Subject"] = subject
        msg.set_content(body)
        try:
            with smtplib.SMTP(self.host, self.port, timeout=30) as s:
                if self.starttls:
                    s.starttls()
                if self.username:
                    s.login(self.username, self.password or "")
                s.send_message(msg)
            return True
        except (OSError, smtplib.SMTPException):
            return False
