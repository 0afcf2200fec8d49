"""The admission plane of the port: so far the priority resolution the
disruption methods' candidate order breaks ties with (``priority.py``).
The tiers, gangs and preemption are ROADMAP.md Queue 1 item 16."""
