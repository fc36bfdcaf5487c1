"""``messaging_pb`` messages and the ``SeaweedMessaging`` service.

Field names, numbers and kinds are those of
``seaweedfs_tpu/pb/proto/messaging.proto`` (its generated
``messaging_pb2`` descriptors are the reference a test holds this table
against), upstream's misspelt ``FindBrokerRequest.parition`` and
``TopicConfiguration.partitoning`` included; the wire runtime is
``pb/wire.py``. ``Message.headers`` is a ``map<string, bytes>``.
``Subscribe`` and ``Publish`` stream both ways, on ``rpc.py``.
"""

from seaweedfs_tpu_torch.pb.wire import (SINGLE, enum_type, message,
                                         resolve)

PACKAGE = "messaging_pb"

SubscriberMessage = message("SubscriberMessage", [
    ("init", 1, "message", SINGLE, "InitMessage"),
    ("ack", 2, "message", SINGLE, "AckMessage"),
    ("is_close", 3, "bool"),
])

SubscriberMessage.InitMessage = message("InitMessage", [
    ("namespace", 1, "string"),
    ("topic", 2, "string"),
    ("partition", 3, "int32"),
    ("startPosition", 4, "enum", None, "StartPosition"),
    ("timestampNs", 5, "int64"),
    ("subscriber_id", 6, "string"),
])

SubscriberMessage.InitMessage.StartPosition = enum_type("StartPosition", {
    "LATEST": 0, "EARLIEST": 1, "TIMESTAMP": 2})

SubscriberMessage.AckMessage = message("AckMessage", [
    ("message_id", 1, "int64"),
])

Message = message("Message", [
    ("event_time_ns", 1, "int64"),
    ("key", 2, "bytes"),
    ("value", 3, "bytes"),
    ("headers", 4, "map", "string", "bytes"),
    ("is_close", 5, "bool"),
])

BrokerMessage = message("BrokerMessage", [
    ("data", 1, "message", SINGLE, "Message"),
])

PublishRequest = message("PublishRequest", [
    ("init", 1, "message", SINGLE, "InitMessage"),
    ("data", 2, "message", SINGLE, "Message"),
])

PublishRequest.InitMessage = message("InitMessage", [
    ("namespace", 1, "string"),
    ("topic", 2, "string"),
    ("partition", 3, "int32"),
])

PublishResponse = message("PublishResponse", [
    ("config", 1, "message", SINGLE, "ConfigMessage"),
    ("redirect", 2, "message", SINGLE, "RedirectMessage"),
    ("is_closed", 3, "bool"),
])

PublishResponse.ConfigMessage = message("ConfigMessage", [
    ("partition_count", 1, "int32"),
])

PublishResponse.RedirectMessage = message("RedirectMessage", [
    ("new_broker", 1, "string"),
])

DeleteTopicRequest = message("DeleteTopicRequest", [
    ("namespace", 1, "string"),
    ("topic", 2, "string"),
])

DeleteTopicResponse = message("DeleteTopicResponse", [])

ConfigureTopicRequest = message("ConfigureTopicRequest", [
    ("namespace", 1, "string"),
    ("topic", 2, "string"),
    ("configuration", 3, "message", SINGLE, "TopicConfiguration"),
])

ConfigureTopicResponse = message("ConfigureTopicResponse", [])

GetTopicConfigurationRequest = message("GetTopicConfigurationRequest", [
    ("namespace", 1, "string"),
    ("topic", 2, "string"),
])

GetTopicConfigurationResponse = message("GetTopicConfigurationResponse", [
    ("configuration", 1, "message", SINGLE, "TopicConfiguration"),
])

FindBrokerRequest = message("FindBrokerRequest", [
    ("namespace", 1, "string"),
    ("topic", 2, "string"),
    ("parition", 3, "int32"),
])

FindBrokerResponse = message("FindBrokerResponse", [
    ("broker", 1, "string"),
])

TopicConfiguration = message("TopicConfiguration", [
    ("partition_count", 1, "int32"),
    ("collection", 2, "string"),
    ("replication", 3, "string"),
    ("is_transient", 4, "bool"),
    ("partitoning", 5, "enum", None, "Partitioning"),
])

TopicConfiguration.Partitioning = enum_type("Partitioning", {
    "NonNullKeyHash": 0, "KeyHash": 1, "RoundRobin": 2})

resolve(globals(), PACKAGE)

# service -> [(method, request, response, client streaming, server
# streaming)]
SERVICES = {
    "SeaweedMessaging": [
        ("Subscribe", SubscriberMessage, BrokerMessage, True, True),
        ("Publish", PublishRequest, PublishResponse, True, True),
        ("DeleteTopic", DeleteTopicRequest, DeleteTopicResponse,
         False, False),
        ("ConfigureTopic", ConfigureTopicRequest, ConfigureTopicResponse,
         False, False),
        ("GetTopicConfiguration", GetTopicConfigurationRequest,
         GetTopicConfigurationResponse, False, False),
        ("FindBroker", FindBrokerRequest, FindBrokerResponse, False, False),
    ],
}
