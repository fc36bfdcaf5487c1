"""What each part of the JAX package that the port does not carry yet
arrives with. Every refusal quotes one of these, so a request for an
unported part gets an error naming its ROADMAP item, never a weaker
result."""

FUSE = "FUSE: mount and filesys/ (ROADMAP Queue 1 item 13)"
NOTIFICATION = ("notification and messaging: the queues, fs.meta.notify "
                "and msgBroker (ROADMAP Queue 1 item 14)")


class NotPortedError(ValueError):
    """A request for a part the port does not carry yet."""


def refusal(what: str, arrives_with: str) -> NotPortedError:
    return NotPortedError(f"{what} is not carried by this port: it "
                          f"arrives with {arrives_with}")
