"""AWS SQS notification queue over plain HTTP + SigV4 — no SDK.

Behavioral parity with the reference's aws-sdk-go publisher
(weed/notification/aws_sqs/aws_sqs_pub.go:17-100): resolve the queue
URL by name at startup (GetQueueUrl), then SendMessage per event with
the event key in a `key` message attribute and the EventNotification
in protobuf text format as the body. The wire protocol is the SQS
query API: form-encoded POSTs signed with SigV4 service="sqs".

The port of ``seaweedfs_tpu_torch.notification.aws_sqs``: the same requests,
signed by the port's ``util/aws_auth``; the body is the event in
protobuf's text format as ``pb/wire.py`` prints it.
"""

from __future__ import annotations

import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from typing import List, Tuple

from seaweedfs_tpu_torch.notification import MessageQueue
from seaweedfs_tpu_torch.util.aws_auth import sigv4_headers


class SqsError(Exception):
    pass


class AwsSqsQueue(MessageQueue):
    def __init__(self, sqs_queue_name: str = "",
                 aws_access_key_id: str = "",
                 aws_secret_access_key: str = "",
                 region: str = "us-east-1",
                 endpoint: str = "", queue_url: str = "",
                 timeout: float = 30.0, **_ignored):
        """`queue_url` skips discovery (also the local-emulator path);
        otherwise GetQueueUrl on `endpoint` (default: the public
        sqs.<region>.amazonaws.com) resolves `sqs_queue_name`."""
        self.access_key = aws_access_key_id
        self.secret_key = aws_secret_access_key
        self.region = region
        self.timeout = timeout
        if not endpoint:
            # the real AWS endpoint is TLS-only
            self.endpoint = f"https://sqs.{region}.amazonaws.com"
        elif "://" in endpoint:
            self.endpoint = endpoint.rstrip("/")
        else:
            # bare host:port means a local emulator; those speak http
            self.endpoint = f"http://{endpoint}"
        if queue_url:
            self.queue_url = queue_url
        else:
            if not sqs_queue_name:
                raise ValueError(
                    "aws_sqs needs sqs_queue_name or queue_url")
            self.queue_url = self._get_queue_url(sqs_queue_name)

    # -- SQS query-protocol plumbing -----------------------------------------

    def _call(self, url: str, params: List[Tuple[str, str]]) -> bytes:
        u = urllib.parse.urlparse(
            url if "://" in url else f"https://{url}")
        payload = urllib.parse.urlencode(params,
                                         quote_via=urllib.parse.quote
                                         ).encode()
        headers = sigv4_headers(
            "POST", u.netloc, u.path or "/", [],
            {"content-type": "application/x-www-form-urlencoded"},
            payload, self.access_key, self.secret_key, self.region,
            "sqs")
        req = urllib.request.Request(
            f"{u.scheme}://{u.netloc}{u.path or '/'}",
            data=payload, method="POST", headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            raise SqsError(
                f"SQS HTTP {e.code}: "
                f"{e.read().decode('utf-8', 'replace')[:300]}") from None
        except OSError as e:   # URLError, timeouts, refused connections
            raise SqsError(f"SQS {u.netloc} unreachable: {e}") from None

    def _get_queue_url(self, name: str) -> str:
        body = self._call(self.endpoint, [
            ("Action", "GetQueueUrl"), ("QueueName", name),
            ("Version", "2012-11-05")])
        url = _find_text(body, "QueueUrl")
        if not url:
            raise SqsError(f"unable to find queue {name}")
        return url

    # -- MessageQueue SPI -----------------------------------------------------

    def send_message(self, key, event) -> None:
        self._call(self.queue_url, [
            ("Action", "SendMessage"),
            ("MessageAttribute.1.Name", "key"),
            ("MessageAttribute.1.Value.DataType", "String"),
            ("MessageAttribute.1.Value.StringValue", key),
            ("MessageBody", str(event)),
            # the reference publisher delays every message 10s
            # (aws_sqs_pub.go SendMessageInput.DelaySeconds); keep
            # consumer-visible timing identical
            ("DelaySeconds", "10"),
            ("Version", "2012-11-05")])


def _find_text(xml_blob: bytes, tag: str) -> str:
    root = ET.fromstring(xml_blob)
    for el in root.iter():
        if el.tag.endswith(tag):
            return el.text or ""
    return ""
