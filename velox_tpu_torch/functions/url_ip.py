"""The IP-address functions, in dictionary space.

Counterpart of ``velox_tpu/functions/url_ip.py`` (velox/functions/
prestosql IPAddressFunctions.h): ``ip_prefix``, ``ip_subnet_min``,
``ip_subnet_max``, ``is_subnet_of`` and ``is_private_ip``. IPADDRESS and
IPPREFIX are VARCHAR in their canonical text, as in the reference; each
distinct value parses once on the host with Python's ``ipaddress``, and
an invalid one gives NULL. The URL functions are in
functions/strings_ext.py.
"""

from __future__ import annotations

import ipaddress

from velox_tpu_torch import types as T
from velox_tpu_torch.functions.registry import register
from velox_tpu_torch.functions.scalar import (
    _dict_lookup, _dict_map_nullable, _str_resolver,
)


def _ip(s: str):
    try:
        return ipaddress.ip_address(s.strip())
    except ValueError:
        return None


def _net(s: str):
    try:
        return ipaddress.ip_network(s.strip(), strict=False)
    except ValueError:
        return None


def _ip_prefix(s: str, bits: int):
    a = _ip(s)
    if a is None:
        return None
    try:
        return str(ipaddress.ip_network(f"{a}/{bits}", strict=False))
    except ValueError:
        return None


def _subnet_min(s: str):
    n = _net(s)
    return None if n is None else str(n.network_address)


def _subnet_max(s: str):
    n = _net(s)
    return None if n is None else str(n.broadcast_address)


def _is_private(s: str):
    a = _ip(s)
    return None if a is None else bool(a.is_private)


def _ip_prefix_eval(ctx, out_dtype, args):
    if args[1].py_value is None:
        raise NotImplementedError(
            "ip_prefix: prefix length must be a constant")
    bits = int(args[1].py_value)
    return _dict_map_nullable(args[0], lambda s: _ip_prefix(s, bits),
                              "ip_prefix")


register("ip_prefix",
         lambda ts: T.VARCHAR if len(ts) == 2 and ts[0].is_string
         and ts[1].is_integral else None, _ip_prefix_eval)
register("ip_subnet_min", _str_resolver(T.VARCHAR),
         lambda ctx, o, a: _dict_map_nullable(a[0], _subnet_min,
                                              "ip_subnet_min"))
register("ip_subnet_max", _str_resolver(T.VARCHAR),
         lambda ctx, o, a: _dict_map_nullable(a[0], _subnet_max,
                                              "ip_subnet_max"))
register("is_private_ip", _str_resolver(T.BOOLEAN),
         lambda ctx, o, a: _dict_lookup(a[0], _is_private, T.BOOLEAN,
                                        "is_private_ip"))


def _in_net(a, net):
    """Whether address or network ``a`` lies in ``net``; None if either
    did not parse."""
    if a is None or net is None:
        return None
    if a.version != net.version:
        return False
    return a.subnet_of(net) if isinstance(
        a, (ipaddress.IPv4Network, ipaddress.IPv6Network)) else a in net


def _is_subnet_of_eval(ctx, out_dtype, args):
    """is_subnet_of(prefix, ip_or_prefix): one side a constant."""
    pfx, ip = args
    if pfx.py_value is not None:
        net = _net(pfx.py_value)
        return _dict_lookup(
            ip, lambda s: _in_net(_net(s) if "/" in s else _ip(s), net),
            T.BOOLEAN, "is_subnet_of")
    if ip.py_value is not None:
        a = _ip(ip.py_value)
        return _dict_lookup(pfx, lambda s: _in_net(a, _net(s)), T.BOOLEAN,
                            "is_subnet_of")
    raise NotImplementedError(
        "is_subnet_of: one argument must be a constant")


register("is_subnet_of",
         lambda ts: T.BOOLEAN if len(ts) == 2
         and all(t.is_string for t in ts) else None, _is_subnet_of_eval)
