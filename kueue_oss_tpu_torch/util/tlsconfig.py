"""TLS options of the Configuration.

A copy of part of ``kueue_oss_tpu/util/tlsconfig.py`` (reference:
pkg/util/tlsconfig/tlsconfig.go): the ``TLSOptions`` dataclass that
``config.load`` builds and ``parse_tls_options`` (ParseTLSOptions),
which ``config.validate`` runs under the TLSOptions gate: it rejects
pre-1.2 versions and unknown cipher names. ``build_ssl_context`` is cut:
the port serves no HTTP.
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass, field
from typing import Optional

_VERSIONS = {
    "": ssl.TLSVersion.TLSv1_2,
    "VersionTLS12": ssl.TLSVersion.TLSv1_2,
    "VersionTLS13": ssl.TLSVersion.TLSv1_3,
}
_REJECTED_VERSIONS = {"VersionTLS10", "VersionTLS11"}


class TLSOptionsError(ValueError):
    pass


@dataclass
class TLSOptions:
    """Configuration.tls analog (config TLSOptions struct)."""

    min_version: str = ""
    cipher_suites: list[str] = field(default_factory=list)
    #: PEM paths; both required to actually serve TLS
    cert_file: Optional[str] = None
    key_file: Optional[str] = None


@dataclass
class TLS:
    """Parsed options (tlsconfig.go TLS struct analog)."""

    min_version: ssl.TLSVersion
    cipher_suites: list[str] = field(default_factory=list)
    cert_file: Optional[str] = None
    key_file: Optional[str] = None


#: TLS 1.3 suites are configured by OpenSSL's set_ciphersuites, which
#: the Python ssl module does not expose; they are on by default, so
#: naming them validates as a no-op (documented in build_ssl_context).
_TLS13_SUITES = {
    "TLS_AES_128_GCM_SHA256",
    "TLS_AES_256_GCM_SHA384",
    "TLS_CHACHA20_POLY1305_SHA256",
    "TLS_AES_128_CCM_SHA256",
    "TLS_AES_128_CCM_8_SHA256",
}


def _iana_to_openssl(name: str) -> str:
    """Translate an IANA suite name (the format the reference's config
    uses, e.g. TLS_ECDHE_RSA_WITH_AES_128_GCM_SHA256) to OpenSSL's
    (ECDHE-RSA-AES128-GCM-SHA256), which set_ciphers understands."""
    s = name
    if s.startswith("TLS_"):
        s = s[4:]
    s = s.replace("_WITH_", "_")
    s = s.replace("_", "-")
    for bits in ("128", "256"):
        s = s.replace(f"AES-{bits}", f"AES{bits}")
        s = s.replace(f"CAMELLIA-{bits}", f"CAMELLIA{bits}")
    s = s.replace("3DES-EDE-CBC", "DES-CBC3")
    # OpenSSL spells ChaCha20 suites without the HMAC suffix...
    if s.endswith("CHACHA20-POLY1305-SHA256"):
        s = s[: -len("-SHA256")]
    # ...and CBC suites without the CBC token (ECDHE-RSA-AES128-SHA)
    s = s.replace("-CBC-", "-")
    return s


def _settable(cipher_string: str) -> bool:
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    try:
        ctx.set_ciphers(cipher_string)
        return True
    except ssl.SSLError:
        return False


def _resolve_ciphers(names: list[str]) -> tuple[list[str], list[str]]:
    """Per name: accept TLS 1.3 suites as no-ops; otherwise accept the
    OpenSSL spelling directly or via the IANA translation. Returns
    (openssl_names_for_set_ciphers, invalid_names)."""
    resolved, bad = [], []
    for name in names:
        if name in _TLS13_SUITES:
            continue
        if _settable(name):
            resolved.append(name)
        elif _settable(_iana_to_openssl(name)):
            resolved.append(_iana_to_openssl(name))
        else:
            bad.append(name)
    return resolved, bad


def parse_tls_options(cfg: Optional[TLSOptions]) -> Optional[TLS]:
    """Validate and convert (ParseTLSOptions, tlsconfig.go:36-59).

    Returns None for an absent config; raises TLSOptionsError on a
    pre-1.2 minVersion or unknown cipher names.
    """
    if cfg is None:
        return None
    errs = []
    if cfg.min_version in _REJECTED_VERSIONS:
        errs.append("invalid minVersion. Please use VersionTLS12 or "
                    "VersionTLS13")
        version = ssl.TLSVersion.TLSv1_2
    elif cfg.min_version not in _VERSIONS:
        errs.append(f"invalid minVersion {cfg.min_version!r}. Please use "
                    "VersionTLS12 or VersionTLS13")
        version = ssl.TLSVersion.TLSv1_2
    else:
        version = _VERSIONS[cfg.min_version]
    suites = []
    if cfg.cipher_suites:
        resolved, bad = _resolve_ciphers(cfg.cipher_suites)
        if bad:
            errs.append(f"invalid cipher suites: {bad}. Please use "
                        "secure cipher names (IANA or OpenSSL format)")
        else:
            suites = resolved
    if errs:
        raise TLSOptionsError("; ".join(errs))
    return TLS(min_version=version, cipher_suites=suites,
               cert_file=cfg.cert_file, key_file=cfg.key_file)
