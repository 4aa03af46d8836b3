"""Builtin observability services and pages of the port
(brpc_tpu/builtin/, bRPC's builtin services): ``services.py`` builds
the page payloads and the ``builtin`` tpu_std service, ``tabbed.py`` the
HTML index."""
