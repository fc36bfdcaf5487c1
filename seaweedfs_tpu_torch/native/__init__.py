"""Host-side native helpers built with g++ at first use."""
