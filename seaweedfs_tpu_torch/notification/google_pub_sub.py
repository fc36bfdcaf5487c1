"""Google Cloud Pub/Sub notification queue over REST — no SDK.

Behavioral parity with the reference's cloud.google.com/go publisher
(weed/notification/google_pub_sub/google_pub_sub.go:20-80): reads the
service-account JSON named by `google_application_credentials` (or the
GOOGLE_APPLICATION_CREDENTIALS env var), ensures the topic exists
(create-if-missing), and publishes one message per event with the key
in attributes and the serialized EventNotification as data.

Auth is the standard service-account OAuth2 flow implemented directly:
a self-signed RS256 JWT (util/rsa_sign.py) exchanged at token_uri for a
bearer token, cached until near expiry.

The port of ``seaweedfs_tpu_torch.notification.google_pub_sub``.
"""

from __future__ import annotations

import base64
import json
import os
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from seaweedfs_tpu_torch.notification import MessageQueue
from seaweedfs_tpu_torch.util import rsa_sign

PUBSUB_SCOPE = "https://www.googleapis.com/auth/pubsub"


class PubSubError(Exception):
    pass


class GooglePubSubQueue(MessageQueue):
    def __init__(self, google_application_credentials: str = "",
                 project_id: str = "", topic: str = "",
                 endpoint: str = "https://pubsub.googleapis.com",
                 timeout: float = 30.0, **_ignored):
        creds_path = google_application_credentials or \
            os.environ.get("GOOGLE_APPLICATION_CREDENTIALS", "")
        if not creds_path:
            raise ValueError(
                "google_pub_sub needs google_application_credentials "
                "(or the GOOGLE_APPLICATION_CREDENTIALS env var)")
        with open(creds_path) as f:
            creds = json.load(f)
        self.key = rsa_sign.parse_private_key_pem(creds["private_key"])
        self.client_email = creds["client_email"]
        self.token_uri = creds.get(
            "token_uri", "https://oauth2.googleapis.com/token")
        self.project_id = project_id or creds.get("project_id", "")
        if not self.project_id or not topic:
            raise ValueError("google_pub_sub needs project_id and topic")
        self.topic = topic
        self.endpoint = endpoint.rstrip("/")
        self.timeout = timeout
        self._token: Optional[str] = None
        self._token_expiry = 0.0
        self._ensure_topic()

    # -- OAuth2 service-account flow ------------------------------------------

    def _bearer(self) -> str:
        if self._token and time.time() < self._token_expiry - 60:
            return self._token
        now = int(time.time())
        assertion = rsa_sign.make_jwt(self.key, {
            "iss": self.client_email, "scope": PUBSUB_SCOPE,
            "aud": self.token_uri, "iat": now, "exp": now + 3600})
        body = urllib.parse.urlencode({
            "grant_type": "urn:ietf:params:oauth:grant-type:jwt-bearer",
            "assertion": assertion}).encode()
        doc = json.loads(self._http("POST", self.token_uri, body,
                                    {"Content-Type":
                                     "application/x-www-form-urlencoded"}))
        self._token = doc["access_token"]
        self._token_expiry = time.time() + float(
            doc.get("expires_in", 3600))
        return self._token

    def _http(self, method: str, url: str, body: Optional[bytes],
              headers: dict) -> bytes:
        req = urllib.request.Request(url, data=body, method=method,
                                     headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            raise PubSubError(
                f"pubsub HTTP {e.code} on {method} {url}: "
                f"{e.read().decode('utf-8', 'replace')[:300]}") from None
        except OSError as e:
            raise PubSubError(f"pubsub {url} unreachable: {e}") from None

    def _api(self, method: str, path: str,
             doc: Optional[dict] = None) -> dict:
        body = json.dumps(doc).encode() if doc is not None else None
        raw = self._http(
            method, f"{self.endpoint}/v1/{path}", body,
            {"Authorization": f"Bearer {self._bearer()}",
             "Content-Type": "application/json"})
        return json.loads(raw) if raw else {}

    # -- topic lifecycle ------------------------------------------------------

    @property
    def _topic_path(self) -> str:
        return f"projects/{self.project_id}/topics/{self.topic}"

    def _ensure_topic(self) -> None:
        """Create-if-missing, like the reference's Exists/CreateTopic."""
        try:
            self._api("GET", self._topic_path)
        except PubSubError as e:
            if "HTTP 404" not in str(e):
                raise
            self._api("PUT", self._topic_path, {})

    # -- MessageQueue SPI -----------------------------------------------------

    def send_message(self, key, event) -> None:
        self._api("POST", f"{self._topic_path}:publish", {
            "messages": [{
                "data": base64.b64encode(
                    event.SerializeToString()).decode(),
                "attributes": {"key": key},
            }]})
