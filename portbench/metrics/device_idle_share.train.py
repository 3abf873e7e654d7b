"""``device_idle_share.train``: ``device_idle_share.prefill``'s reading
(the traced segment's share with no kernel or copy on the device) over
the traced training steps."""

from portbench.spec import reader

read = reader("device_idle_share.prefill").read
