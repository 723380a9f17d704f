"""Network helpers (copied from ``blendjax/utils/ipaddr.py``): the IP of
the default-route interface, for a launcher that binds its producers on
``bind_addr='primaryip'`` so a consumer on another machine can reach them.
"""

from __future__ import annotations

import socket


def get_primary_ip() -> str:
    """IP of the default-route interface; loopback when there is none.
    The UDP ``connect`` picks the route without sending a packet."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()
