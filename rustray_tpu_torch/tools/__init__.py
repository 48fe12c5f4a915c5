"""The port's tools: wavefront capture and the octet kernel bench."""
