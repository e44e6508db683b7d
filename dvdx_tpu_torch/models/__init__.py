"""Model definitions of the port (channel-last at every public function)."""
