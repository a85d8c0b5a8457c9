from sgp.analysis.whiteness import (AZWhitenessMultiTestResult,
                                    AZWhitenessTestResult,
                                    az_whiteness_test)

__all__ = ["AZWhitenessMultiTestResult", "AZWhitenessTestResult",
           "az_whiteness_test"]
