"""The traffic drivers: one module a kind of traffic, named by the
``driver`` key of a traffic file."""
