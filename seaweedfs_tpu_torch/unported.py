"""What each part of the JAX package that the port does not carry yet
arrives with. Every refusal quotes one of these, so a request for an
unported part gets an error naming its ROADMAP item, never a weaker
result."""

GATEWAYS_ITEM = "ROADMAP Queue 1 item 13"
NETWORKED_STORES = f"the networked filer stores ({GATEWAYS_ITEM})"
FUSE = f"FUSE: mount and filesys/ ({GATEWAYS_ITEM})"
NOTIFICATION = ("the async services and notification (ROADMAP Queue 1 "
                "item 14)")


class NotPortedError(ValueError):
    """A request for a part the port does not carry yet."""


def refusal(what: str, arrives_with: str) -> NotPortedError:
    return NotPortedError(f"{what} is not carried by this port: it "
                          f"arrives with {arrives_with}")
