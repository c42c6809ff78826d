"""The benchmark's frozen arithmetic: operations and bytes from the
configurations' shapes, and the card's published peaks."""
