"""Embedded binary constant tables of the CRI HCA bitstream format.

Format-defined lookup tables (psychoacoustic ATH curve, resolution inversion
table, IMDCT twiddle factors and window, the encoder's DCT-IV twiddles and
quantiser tables) whose exact fp32 bit patterns are required for bit-exact
decode and encode. Stored as base85 blobs, decoded once at import;
the same blobs as pycricodecs_tpu/ops/_hca_data.py (tests hold them equal).
Parity anchors in the reference implementation: hca.cpp:407 (ath),
hca.cpp:1444-1494 (invert table), hca.cpp:1741-1894 (IMDCT twiddles/window),
hca.cpp:2030-2112 (encoder DCT-IV twiddles, shuffle, quantiser and channel
mapping tables).
"""
import base64

import numpy as np


def _f32(blob):
    return np.frombuffer(base64.b85decode(blob), dtype="<u4").view(np.float32).copy()


def _u8(blob):
    return np.frombuffer(base64.b85decode(blob), dtype="u1").copy()


ATH_BASE_CURVE = _u8(
    "cwbggPE1QlNJvLUMny$ML_|bHLqkJDLqkGBLPA19LP9}7K|w)5K|w)5KtMo1KtMo1KtDe}KR-V|KR-V|KR-V{K0ZD^K0Q4>J"
    "v}`=JUl!+JUl!+J3Bi&J3Bi&J3Bi&J3Bi&J3Bi&J3Bi&J3Bi&J3Bi&JUl!+JUl!+Jv}`=Jv}`=K0ZD^K0ZD_KR-V|KR-V|KR"
    "-V|KR-V|KR-V|KtMo1KtMo1KtMo1KtMo1KtMo1KtVx4K|w)5K|w)5K|w)5K|w)5K|w)5K|w)5K|w)6LPA19LPA19LPA19LPA"
    "19LPA19LPJACLqkJDLqkJDLqkJDLqkMFL_|bHL_|bHL_|bHMMXtLMMXtLMMXtLMn*<PMn*<PMn*?RM@L6TM@L6TNJvOXNJvO"
    "XNl8gbNl8gbN=iyfN=iyfOG`^jOG`^kOiWBnOifKqO-)TsPEJlvPESuyPft%!P*6}%QBhG*QBqP;Qc_b>Q&Ut_R8&+|RaI41"
    "R#sM5S65e8SXfwDSy@?HT3T9LTU%RPTwGmUU0q&YUSD5dU|?WjVPRonVq#-sV`OAxWo2e&W@l$-XlQ6@X=-X}Yinz4Y;A3AZ"
    "f<XHaBy&OadL8Vb8~cbb#-=jcXxPrczJnxdV70(e0_a>et&;}fPsO6gM);Gg@uNOhlq%YiHeGgjEs$qj*pL!kdcy-la!Q|m6"
    "n&6n3<WHo12`Sot~edprN9oqok#!rl+T<sj8~0tgWuDuduPPva__cwzjvpxw^W$yuH4^z`?=7!^FkL$H>Xa%FE2n&d<=%($m"
    "z{*4NnC+S}aS-rwNi;^XAy=I7|?>g(<9@9^>R^Yr!i`1$(#{Qdv`"
)

INVERT_TABLE = _u8(
    "4h{|u4h{_s4Gj$q3=9km3=9hk3kwSi3JMAe3JMAd2?+@a2?z)X2nYxV1_lKL1Ox*E0|Ej90s#R50RaI40Ra"
)

IMDCT_SIN = _f32(
    "bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&b"
    "v>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv"
    ">s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>"
    "s&bv>s&bv>s&bv>s&bv>s&bv>s&bv>s&z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^"
    "uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>"
    "z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG"
    "22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>z7%^uG22u>ZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8"
    "jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J"
    "|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>"
    "*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?NZNz>*3;J|Fn8jf~1LQ?N"
    "53zqgtU7%^_)~a42nlgN*lTA$8kAc<0-sGk`K~=b53zqgtU7%^_)~a42nlgN*lTA$8kAc<0-sGk`K~=b53zqgtU7%^_)~a42"
    "nlgN*lTA$8kAc<0-sGk`K~=b53zqgtU7%^_)~a42nlgN*lTA$8kAc<0-sGk`K~=b53zqgtU7%^_)~a42nlgN*lTA$8kAc<0-"
    "sGk`K~=b53zqgtU7%^_)~a42nlgN*lTA$8kAc<0-sGk`K~=b53zqgtU7%^_)~a42nlgN*lTA$8kAc<0-sGk`K~=b53zqgtU7"
    "%^_)~a42nlgN*lTA$8kAc<0-sGk`K~=bL+pP)ZBBnbBolr=C_8*VoyU1U2fB7YM-+2Ep4e_brwM95S*m0|1-@QCQ%G1pJxx("
    "R646ONaM(dVLTEWZL+pP)ZBBnbBolr=C_8*VoyU1U2fB7YM-+2Ep4e_brwM95S*m0|1-@QCQ%G1pJxx(R646ONaM(dVLTEWZ"
    "L+pP)ZBBnbBolr=C_8*VoyU1U2fB7YM-+2Ep4e_brwM95S*m0|1-@QCQ%G1pJxx(R646ONaM(dVLTEWZL+pP)ZBBnbBolr=C"
    "_8*VoyU1U2fB7YM-+2Ep4e_brwM95S*m0|1-@QCQ%G1pJxx(R646ONaM(dVLTEWZ5&M5Xm(zbgtAu|)SPp+buyB4q%&UDr$-"
    "jI*&8&Mr0&{vlm=bwE#fx`8#@=;5-3xR-QWJ7NbM<dOld^3;3`=W2Jill^h!18zT0CPvAx2<7Q!QOTYVuh><&{=HNf=W<A9_"
    "ze_`6F#W!^_W0OCVGXU9K3JC8d*BRV%f5&M5Xm(zbgtAu|)SPp+buyB4q%&UDr$-jI*&8&Mr0&{vlm=bwE#fx`8#@=;5-3xR"
    "-QWJ7NbM<dOld^3;3`=W2Jill^h!18zT0CPvAx2<7Q!QOTYVuh><&{=HNf=W<A9_ze_`6F#W!^_W0OCVGXU9K3JC8d*BRV%f"
    "#QuLj=JbC*DdB%VkHddI7@U7U$7+8+oiBeso$7u+$(w#ZBSU^avEY3_baZ_`bN+lkuzq|$G4*>t{9$`P7R7o$gdTc7PHuTWd"
    "$f2z5b<|E7bJH-mrZs*mu+=FB7}55Kaq1k_>^)#SC4T&W`J-%FlcW-zD9089UN^xSm<j%d#h?ck!5K=s1|5H%)Vwn3tnYEbM"
    "#|B5Q1Vq@&;i)Cxc%<zV=-|$6;JQP{dk4Y93iXCU93jletwt!}?P{#xqhsuVhd^kd011d9F-9f5%Ecv)D*KD&j^z_2Wc8Dc("
    "Xq+R#8h8@xV01E4%Vq<lI*7E(ArY#=s2"
).reshape(7, 64)

IMDCT_COS = _f32(
    ")Qbwe)Qbu|)Qbu|)Qbwe)Qbu|)Qbwe)Qbwe)Qbu|)Qbu|)Qbwe)Qbwe)Qbu|)Qbwe)Qbu|)Qbu|)Qbwe)Qbu|)Qbwe)Qbwe)"
    "Qbu|)Qbwe)Qbu|)Qbu|)Qbwe)Qbwe)Qbu|)Qbu|)Qbwe)Qbu|)Qbwe)Qbwe)Qbu|)Qbu|)Qbwe)Qbwe)Qbu|)Qbwe)Qbu|)Q"
    "bu|)Qbwe)Qbwe)Qbu|)Qbu|)Qbwe)Qbu|)Qbwe)Qbwe)Qbu|)Qbwe)Qbu|)Qbu|)Qbwe)Qbu|)Qbwe)Qbwe)Qbu|)Qbu|)Qb"
    "we)Qbwe)Qbu|)Qbwe)Qbu|)Qbu|)Qbwe!o^3v+Bput!o^2E+BptC!o^2E+BptC!o^3v+Bput!o^2E+BptC!o^3v+Bput!o^3"
    "v+Bput!o^2E+BptC!o^2E+BptC!o^3v+Bput!o^3v+Bput!o^2E+BptC!o^3v+Bput!o^2E+BptC!o^2E+BptC!o^3v+Bput"
    "!o^2E+BptC!o^3v+Bput!o^3v+Bput!o^2E+BptC!o^3v+Bput!o^2E+BptC!o^2E+BptC!o^3v+Bput!o^3v+Bput!o^2E+"
    "BptC!o^2E+BptC!o^3v+Bput!o^2E+BptC!o^3v+Bput!o^3v+Bput!o^2E+BptCHoeHbF`$&b>RR!>nP(!uHoeF_F`$$_>R"
    "RzWnP(zDHoeF_F`$$_>RRzWnP(zDHoeHbF`$&b>RR!>nP(!uHoeF_F`$$_>RRzWnP(zDHoeHbF`$&b>RR!>nP(!uHoeHbF`$"
    "&b>RR!>nP(!uHoeF_F`$$_>RRzWnP(zDHoeF_F`$$_>RRzWnP(zDHoeHbF`$&b>RR!>nP(!uHoeHbF`$&b>RR!>nP(!uHoeF"
    "_F`$$_>RRzWnP(zDHoeHbF`$&b>RR!>nP(!uHoeF_F`$$_>RRzWnP(zDHoeF_F`$$_>RRzWnP(zDHoeHbF`$&b>RR!>nP(!u"
    "F#AZogFqI(%+Gkf)O@VIfau!3J)8r-z<(IOO6x1XF#AY7gFqHO%+Gi})O@TyfauyjJ)8qSz<(G&O6w~>F#AY7gFqHO%+Gi})"
    "O@TyfauyjJ)8qSz<(G&O6w~>F#AZogFqI(%+Gkf)O@VIfau!3J)8r-z<(IOO6x1XF#AY7gFqHO%+Gi})O@TyfauyjJ)8qSz<"
    "(G&O6w~>F#AZogFqI(%+Gkf)O@VIfau!3J)8r-z<(IOO6x1XF#AZogFqI(%+Gkf)O@VIfau!3J)8r-z<(IOO6x1XF#AY7gFq"
    "HO%+Gi})O@TyfauyjJ)8qSz<(G&O6w~>unNh%1*w+3bF%uqq7W~>6I@`vla7eK<(i<rDnz)x%6regbu;F^Ctdu$oAn64Drgh"
    "G(SIGkRyHTUyM-{nunNgM1*w)jbF%t9q7W}W6I@_Ela7c!<(i;ADnz(G%6rc~bu;EZCtdtLoAn4kDrgfw(SIF3RyHR;yM-`6"
    "unNgM1*w)jbF%t9q7W}W6I@_Ela7c!<(i;ADnz(G%6rc~bu;EZCtdtLoAn4kDrgfw(SIF3RyHR;yM-`6unNh%1*w+3bF%uqq"
    "7W~>6I@`vla7eK<(i<rDnz)x%6regbu;F^Ctdu$oAn64DrghG(SIGkRyHTUyM-{nkPb<_EW;MPbSrzkfVQu_F1+ErhR+GUwy"
    "Pq(&u%-u0Tooff0}H*z<q+gBASlAhM=0h5|5_7?_;vQN*%twQ@P2$K{nOCPm<uiyUXjo%i#9D<mUjtf=dR!Ynltc&C?LS+4d"
    "E`#sV9^%l03?CDJ6n6_hEz-a9V8$;dLlkPb;aEW;K(bSry3fVQtaF1+DAhR+E;wyPpO&u%+D0Tom}f0}GQz<q)~BASjqhM<~"
    "05|5@n?_;t)N*%sFQ@P1LK{nMsPm<t1yUXi7%i#7t<mUiCf=dQJYnlr`&C?J++4dDb#sV8Z%l02XCDJ566_hDI-a9To$;dK4"
    "h!4rTw#k;fx=H)I2jDNgX%u3;3LuKTj4-3U!#cdZxjogrb~x_60+j>4w+Ilv-gX?m{N5<Om_RkYH=9AeVD3%6mpNL#W_)J8Q"
    "MPiv;pTq6&W44)2bGJy-JOxX7onHFc%GfU#g(JJ#D=N9I&rVQ>{PYBpfS6?9tXj`Db>cli<`{830l&=YY^DJdA{Ag`eWn1w*"
    "cwBd6e$H2OsplEui_nvKRlpu|fjBg!BZzHlYW<tw;*L(CQ4ogoh8mupSb>Ij|JJ2Rs+Q0Kyr+3_={g61*P2`7a^AshuOg3I!"
    "&=1!gF}g1{=jX%sELrC~3>9jGzCyyr8&"
).reshape(7, 64)

IMDCT_WINDOW = _f32(
    "@B}qFxPt*ZIK^-~Xp*}-38(}-0D>?)OekSI7e9+Uk~ye6y?@6%5E1D-&36Vp#E%(0T+=N*Lq<bA!R%Q*sLOFZ9(0906Qq(ow"
    "0NLBBK594o*ceCd-Baa9eUn9?Y8edE7kx$+Aaz{D(4eEu>c-E@_Z;hRb4YaA)`J%bx%q@KVw!tH{W7D(Zg>(I1zn5qGN?Vw{"
    "na=VYQP!?<$)<Z_=VZtE#F#BC@hR2IsmyH%G%hJ<!WOMt{^kC{f)$TtenP|4#2d*K+tisnh^J%60`mI~@u?NW~66C2SKv@(v"
    "h3!m1oUqC6o#rNJdX=Qb)on3*m=1?Mt9o*Xy7{x>_n@-{!efEPo*=GR8Qq;^WbeDY1dZ%R?W#eG!21B_R{?sQtehd5oo2iIS"
    "}+E8M@nWkjF2-#-84(VvWvDa$95vFXvVpVRx=jLy}?^|)d(Y12F=Jj*Gi5+#n6E1eY*C=<tAP;!IG~#%_Orv?fms5JbIrMtJ"
    "NQQgA&I)|L$bx*oChvT|%TRs4j;MXVH}`$NhCP12Dtvyw%(H&K2jzahY!H9HgEoJ^%2$8Cwse2LwvB(kE~9_Hd$oVR_QZd`?"
    "a_a~t=xaVdF6k<knDfIF7kiBi1vTK(D{GAGW>tP+WmjO?f!qikN<za-~WHV{QrNy"
)

DCT4_SIN_FLAT = _f32(
    "^8__N74O47UW05u!o^2EG22u>z7%^u+BptCHoeF_>RRzW1LQ?N3;J|FZNz>*n8jf~nP(zDF`$$_F#AY7%+Gi}fauyjz<(G&`"
    "K~=b8kAc<2nlgNtU7%^53zqg_)~a4*lTA$0-sGkO6w~>J)8qS)O@TygFqHOunNgMbF%t96I@_E<(i;A%6rc~CtdtLDrgfwRy"
    "HR;LTEWZ646ONQ%G1pS*m0|p4e_b2fB7YC_8*VZBBnbL+pP)Bolr=oyU1UM-+2ErwM951-@QCJxx(RaM(dVyM-`6(SIF3oAn"
    "4kbu;EZDnz(Gla7c!q7W}W1*w)jkPb;abSry3F1+DAwyPpO0Tom}z<q)~hM<~0?_;t)Q@P1LPm<t1%i#7tf=dQJ&C?J+#sV8"
    "ZCDJ56-a9ToBRV%fXU9K3W!^_WA9_ze<&{=HQ!QOTT0CPvJill^ld^3;QWJ7N#@=;5m=bwE&8&Mr%&UDrSPp+bm(zbg5&M5X"
    "tAu|)uyB4q$-jI*0&{vl#fx`8-3xR-bM<dO3`=W2h!18zAx2<7YVuh>Nf=W<_`6F#0OCVGJC8d*$;dK46_hDI%l02X+4dDbY"
    "nlr`<mUiCyUXi7K{nMsN*%sF5|5@nBASjqf0}GQ&u%+DhR+E;fVQtaEW;K(h!4p-x=H&yX%u2Tj4-1;xjofA0+j<k-gX>5m_"
    "Ri?VD3#mW_)Ho;pTom2bGIH7onFv#g(HzI&rT)pfS5XDb>b430l%VdA{8~w*cur2Oso4vKRk8g!BYItw;(#goh75Ij|Hz0Ky"
    "qR61*NishuM~1!gEeX%sC#9jGxsY#=s2q<lI*8@xV0Dc(XqD&j^zf5%Eckd011#xqhsletwtY93iX$6;JQCxc%<5Q1Vq3tnY"
    "Es1|5Hd#h?c9UN^xFlcW-SC4T&Kaq1kmu+=F7bJH-d$f2zgdTc7{9$`Puzq|$baZ_`BSU^ao$7u+$7+8+kHddI=JbC*#QuLj"
    "DdB%V7@U7UoiBes$(w#ZvEY3_bN+lkG4*>t7R7o$PHuTW5b<|EmrZs*B7}55_>^)#W`J-%zD908Sm<j%k!5K=%)VwnbM#|B@"
    "&;i)zV=-|P{dk4CU93j!}?P{uVhd^d9F-9v)D*K_2Wc8+R#8h1E4%V7E(Aryyr7NrC~2Wg1{<23I!%V`7a?q3_=_~2Rs))up"
    "SaW(CQ37HlYVUu|fhrEui^6d6e!x`eWlhYY^Bzi<`_o9tXib>{PWr#D=Lpc%Gd;-JOv>&W43PQMPhEmpNKKH=98|{N5-&w+I"
    "kEb~x@m!#cb@3LuI-2jDL~w#k+}"
)

DCT4_COS_FLAT = _f32(
    "^8__NUW05u74O5oz7%^u+BptC!o^3vG22wXZNz>*n8jf~nP(zDF`$$_HoeHb>RR!>1LQ@&3;J}w53zqg_)~a4*lTA$0-sGkO"
    "6w~>J)8qS)O@TygFqHOF#AZo%+Gkffau!3z<(IO`K~>`8kAeV2nlh&tU7(aL+pP)Bolr=oyU1UM-+2ErwM951-@QCJxx(RaM"
    "(dVyM-`6(SIF3oAn4kbu;EZDnz(Gla7c!q7W}W1*w)junNh%bF%uq6I@`v<(i<r%6regCtdu$DrghGRyHTULTEX^646P&Q%G"
    "39S*m2ep4e``2fB8@C_8+=ZBBo`5&M5XtAu|)uyB4q$-jI*0&{vl#fx`8-3xR-bM<dO3`=W2h!18zAx2<7YVuh>Nf=W<_`6F"
    "#0OCVGJC8d*$;dK46_hDI%l02X+4dDbYnlr`<mUiCyUXi7K{nMsN*%sF5|5@nBASjqf0}GQ&u%+DhR+E;fVQtaEW;K(kPb<_"
    "bSrzkF1+ErwyPq(0Toofz<q+ghM=0h?_;vQQ@P2$Pm<ui%i#9Df=dR!&C?LS#sV9^CDJ6n-a9V8BRV&~XU9LkW!^`>A9_!}<"
    "&{>yQ!QP;T0CRFJilnald^5UQWJ8&#@=<mm=bxv&8&OB%&UFBSPp-`m(zd0#QuLjDdB%V7@U7UoiBes$(w#ZvEY3_bN+lkG4"
    "*>t7R7o$PHuTW5b<|EmrZs*B7}55_>^)#W`J-%zD908Sm<j%k!5K=%)VwnbM#|B@&;i)zV=-|P{dk4CU93j!}?P{uVhd^d9F"
    "-9v)D*K_2Wc8+R#8h1E4%V7E(Aryyr7NrC~2Wg1{<23I!%V`7a?q3_=_~2Rs))upSaW(CQ37HlYVUu|fhrEui^6d6e!x`eWl"
    "hYY^Bzi<`_o9tXib>{PWr#D=Lpc%Gd;-JOv>&W43PQMPhEmpNKKH=98|{N5-&w+IkEb~x@m!#cb@3LuI-2jDL~w#k+}h!4rT"
    "x=H)IX%u3;j4-3Uxjogr0+j>4-gX?mm_RkYVD3%6W_)J8;pTq62bGJy7onHF#g(JJI&rVQpfS6?Db>cl30l&=dA{Agw*cwB2"
    "OsplvKRlpg!BZztw;*Lgoh8mIj|JJ0Kyr+61*P2shuOg1!gF}X%sEL9jGzCY#=tjq<lKR8@xWhDc(ZAD&j`Jf5%F{kd02i#x"
    "qjCletyDY93j?$6;K*Cxc(V5Q1XA3tnZvs1|6yd#h@{9UN`HFlcYTSC4VOKaq34mu+>w7bJJTd$f4JgdTdo{9${)uzq~MbaZ"
    "{cBSU__o$7wS$7+ASkHdez=JbER"
)

# DCT4_SIN_FLAT/DCT4_COS_FLAT stage i (0..7) occupies [2**i - 1 : 2**(i+1) - 1]

SHUFFLE_TABLE = _u8(
    "06<_MFmO;17+82XC}>Cs3`}e+JbYXn6jXFHBxFPc21aHkHg;AP9$tPvE^bZ^3QB4!I(k|f5>j$9B4R=U14CmYGjmfD8(VujD"
    "{D&&4^M9|KYw2z7gu*TCuc_o1w~~gHFZ@L9bJ7rEp1H=2}x-wIeA$b5m9k5Az?uQ"
)

SCALE_TO_RESOLUTION_CURVE = _u8(
    "4-O6v4h{|t4Gj$q4Gatn3=9kl3kwSi3knJf3JMAe2?+@a2?+=Y2nYxW2L=WO1Ox;F0|NpA0s;X"
)

QUANTIZE_SPECTRUM_BITS = _u8(
    "0000000000000000000000000000020RjL30000000000000950s;d7000000000000RR90s{jB00000000001Oo#D0|NsC1"
    "ONa4000041Ox*E0|NsD1Oxy8000C81Ox;F0|NvE1Ox;C00aaC1Ox;G0|W#F1Ox;G"
).reshape(8, 16)

QUANTIZE_SPECTRUM_VALUE = _u8(
    "00000000000000000000000000000300IC20000000000000L9009O7000000000000#vF00IOC00000000004+aDR009F94"
    "gdfE0000F4GRPU009FE3=RMQ000jS3ke4T009OF3JeYa01pid2?qrO00IOC2nq}i"
).reshape(8, 16)

VALID_CHANNEL_MAPPINGS = _u8(
    "00961000000RR9100000009920RR910RR92009610099200001000010000000000000010000100000"
).reshape(8, 8)

DEFAULT_CHANNEL_MAPPING = _u8(
    "00965009FB0{"
)

QUANTIZED_SPECTRUM_MAX_BITS = _u8(
    "00IL81Ox;G1qKHQ2?`4g"
)
