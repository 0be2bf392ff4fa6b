"""CephX-style authentication (reference:src/auth/).

Counterpart of ``ceph_tpu/auth``, whole: the messenger's handshake
verifies tickets with it, so a daemon of this package and one of the
reference authenticate each other.

The reference's CephX: every entity holds a shared secret in a
keyring; the mon's auth service verifies an entity's key via
nonce/HMAC challenge and issues time-limited service TICKETS sealed
with the cluster's secret; daemons verify the ticket presented in the
messenger handshake (``AuthAuthorizer``) without talking to the mon
(reference:src/auth/cephx/CephxProtocol.h).

Collapsed to its load-bearing parts (HMAC-SHA256 in place of the
reference's AES construction):

- :class:`Keyring` — entity name -> secret (file- or dict-backed).
- The mon verifies ``auth get-ticket`` requests by HMAC over a fresh
  client nonce and replies with a :class:`Ticket` sealed with the
  CLUSTER secret, plus a ticket-bound SESSION KEY sealed with the
  entity's own secret (CephxServiceTicket::secret analog) — only the
  keyholder can recover it; it never travels in the clear.
- Every daemon holds the cluster secret and verifies tickets inline
  during the messenger handshake; daemons authorize each other with
  the same mechanism (their tickets are self-issued since they hold
  the cluster secret).
- The handshake is challenge-bound: the acceptor sends a fresh nonce
  and requires ``HMAC(session_key, nonce)`` back, so observing one
  handshake does not let you replay the authorizer (the reference
  added the same server challenge for CVE-2018-1128,
  reference:src/msg/async/ProtocolV1 authorizer challenge).
"""

from __future__ import annotations

import hashlib
import hmac
import json
import os
import secrets as _secrets
import time

CLUSTER_ENTITY = "cluster"  # the keyring row daemons share
TICKET_LIFETIME = 3600.0    # reference: auth_service_ticket_ttl


def new_secret() -> str:
    return _secrets.token_hex(16)


def _sig(secret: str, payload: bytes) -> str:
    return hmac.new(secret.encode(), payload, hashlib.sha256).hexdigest()


class Keyring:
    """entity -> secret (reference:src/auth/KeyRing.cc)."""

    def __init__(self, keys: dict[str, str] | None = None):
        self.keys = dict(keys or {})

    @classmethod
    def generate(cls, entities: list[str]) -> "Keyring":
        kr = cls({CLUSTER_ENTITY: new_secret()})
        for e in entities:
            kr.add(e)
        return kr

    def add(self, entity: str, secret: str | None = None) -> str:
        self.keys[entity] = secret or new_secret()
        return self.keys[entity]

    def get(self, entity: str) -> str | None:
        return self.keys.get(entity)

    @property
    def cluster_secret(self) -> str:
        return self.keys[CLUSTER_ENTITY]

    # -- file form (ceph.keyring analog)
    def save(self, path: str) -> None:
        tmp = path + ".tmp"
        # 0600: the file holds every secret in the cluster — a
        # world-readable keyring lets any local user mint tickets
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
        with os.fdopen(fd, "w") as f:
            json.dump(self.keys, f, indent=1)
        os.replace(tmp, path)

    @classmethod
    def load(cls, path: str) -> "Keyring":
        with open(path) as f:
            return cls(json.load(f))


class Ticket:
    """A sealed {entity, expires} claim (CephxTicketBlob analog)."""

    @staticmethod
    def issue(cluster_secret: str, entity: str,
              lifetime: float = TICKET_LIFETIME) -> dict:
        payload = {"entity": entity, "expires": time.time() + lifetime}
        blob = json.dumps(payload, sort_keys=True).encode()
        return {**payload, "sig": _sig(cluster_secret, blob)}

    @staticmethod
    def session_key(cluster_secret: str, ticket: dict) -> str:
        """The ticket-bound session key (CephxServiceTicket secret
        analog).  Derivable only by cluster-secret holders; handed to the
        ticket's owner sealed under its entity secret (:func:`seal_skey`).
        Never sent in the clear — it is what the handshake challenge
        proves possession of."""
        blob = json.dumps(
            {"entity": ticket["entity"], "expires": ticket["expires"]},
            sort_keys=True,
        ).encode()
        return _sig(cluster_secret, b"skey:" + blob)

    @staticmethod
    def verify(cluster_secret: str, ticket: dict | None) -> str | None:
        """Returns the authenticated entity, or None."""
        if not isinstance(ticket, dict):
            return None
        payload = {
            "entity": ticket.get("entity"),
            "expires": ticket.get("expires"),
        }
        if not payload["entity"] or not isinstance(
            payload["expires"], (int, float)
        ):
            return None
        blob = json.dumps(payload, sort_keys=True).encode()
        want = _sig(cluster_secret, blob)
        if not hmac.compare_digest(want, str(ticket.get("sig", ""))):
            return None
        if payload["expires"] < time.time():
            return None
        return payload["entity"]


def challenge_response(entity_secret: str, nonce: str) -> str:
    """The client's proof of key possession (CephxAuthenticate analog)."""
    return _sig(entity_secret, f"cephx-auth:{nonce}".encode())


def seal_skey(entity_secret: str, ticket: dict, skey: str) -> str:
    """Seal a session key under the entity's own secret for transport in
    MAuthReply (the reference encrypts the service ticket with the
    client key; here: XOR with an entity-keyed mask over the ticket
    sig, recoverable only by the keyholder)."""
    mask = _sig(entity_secret, b"seal:" + str(ticket.get("sig", "")).encode())
    return format(int(skey, 16) ^ int(mask, 16), f"0{len(skey)}x")


def unseal_skey(entity_secret: str, ticket: dict, sealed: str) -> str:
    return seal_skey(entity_secret, ticket, sealed)  # XOR is its own inverse


def connection_proof(session_key: str, challenge: str) -> str:
    """The connector's answer to the acceptor's handshake nonce: proves
    possession of the ticket's session key, not just the (observable)
    ticket bytes — replaying a sniffed handshake fails on a new nonce."""
    return _sig(session_key, f"cephx-conn:{challenge}".encode())


def daemon_auth_context(config, name: str) -> "AuthContext | None":
    """The auth context a cluster daemon's messenger runs with: holds
    the cluster secret (so it verifies peers and self-issues its own
    ticket), enforcing when auth_supported=cephx."""
    if getattr(config, "auth_supported", "none") != "cephx":
        return None
    kr = Keyring.load(config.keyring)
    return AuthContext(
        name, cluster_secret=kr.cluster_secret, require=True
    )


class AuthContext:
    """What a messenger needs: my ticket to present, and (daemons) the
    cluster secret to verify peers with."""

    def __init__(self, entity: str, *, cluster_secret: str | None = None,
                 require: bool = False):
        if require and cluster_secret is None:
            # fail closed at construction: a daemon demanding auth
            # without the means to verify it would otherwise accept
            # everyone (ADVICE r2: verify() used to return "" here)
            raise ValueError(
                "AuthContext(require=True) needs the cluster secret"
            )
        self.entity = entity
        self.cluster_secret = cluster_secret
        self.require = require
        self.ticket: dict | None = None
        self.session_key: str | None = None
        if cluster_secret is not None:
            # a cluster-secret holder vouches for itself
            self.ticket = Ticket.issue(cluster_secret, entity)
            self.session_key = Ticket.session_key(cluster_secret, self.ticket)

    REFRESH_MARGIN = 60.0  # re-issue this close to expiry

    def adopt_ticket(self, ticket: dict, session_key: str) -> None:
        """Install a mon-issued ticket + its (unsealed) session key."""
        self.ticket = ticket
        self.session_key = session_key

    def authorizer(self) -> dict | None:
        if (
            self.cluster_secret is not None
            and self.ticket is not None
            and self.ticket["expires"] < time.time() + self.REFRESH_MARGIN
        ):
            # cluster-secret holders re-vouch for themselves; ticketed
            # clients refresh through the mon (RadosClient._authenticate)
            self.ticket = Ticket.issue(self.cluster_secret, self.entity)
            self.session_key = Ticket.session_key(
                self.cluster_secret, self.ticket
            )
        return self.ticket

    def ticket_fresh(self) -> bool:
        return (
            self.ticket is not None
            and self.ticket["expires"] >= time.time() + self.REFRESH_MARGIN
        )

    def prove(self, challenge: str) -> str | None:
        """Connector side: answer the acceptor's handshake nonce."""
        if self.session_key is None:
            return None
        return connection_proof(self.session_key, challenge)

    def verify(self, authorizer: dict | None, *,
               challenge: str | None = None,
               proof: str | None = None) -> str | None:
        """None = reject; entity name = accept.  Only meaningful on
        daemons (cluster-secret holders).

        When ``challenge`` is given (the nonce this acceptor sent), the
        peer must also present ``proof`` == HMAC(session_key, nonce):
        ticket bytes alone — which any observer of a prior handshake
        holds — are not enough."""
        if self.cluster_secret is None:
            # cannot verify anything; only acceptable when not enforcing
            return None if self.require else ""
        if not self.require and authorizer is None:
            return ""
        entity = Ticket.verify(self.cluster_secret, authorizer)
        if entity is None:
            return None
        if challenge is not None:
            skey = Ticket.session_key(self.cluster_secret, authorizer)
            want = connection_proof(skey, challenge)
            if proof is None or not hmac.compare_digest(want, proof):
                return None
        return entity
