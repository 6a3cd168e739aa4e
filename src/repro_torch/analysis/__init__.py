"""Hardware constants of the card the port runs on (``roofline.HW``)."""
