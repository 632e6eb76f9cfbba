"""Runtime: message protocol, transports, server reactor, client engine."""
