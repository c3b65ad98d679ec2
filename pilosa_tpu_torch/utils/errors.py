"""Shared error types.

One canonical not-found type for the whole framework: the executor,
cluster, and API layers all raise (or subclass) this, and the HTTP
layer maps it to 404 by TYPE — never by matching message text (the
reference maps its ErrIndexNotFound/ErrFieldNotFound values in
successResponse.check, http/handler.go:285-310).

Subclasses KeyError so legacy ``except KeyError`` call sites keep
working.
"""


class NotFoundError(KeyError):
    """Missing index / field / view / node / bsiGroup."""

    def __str__(self) -> str:  # KeyError str() adds quotes; we don't want them
        return self.args[0] if self.args else ""
